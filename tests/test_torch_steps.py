"""The port's case builders (`launch/steps.py`) against the reference's, on
the CPU.

- `build_train_step` on `make_host_mesh(device="cpu")` against the
  reference's on its `make_host_mesh()`: one step of stablelm-3b's smoke
  stack (scanned, ``remat``), m = 1 client, the same numpy params and
  tokens, at ``microbatch`` 1 and 2: the loss and CE at rtol 1e-4 (as
  `tests/test_torch_lm_train.py`), the updated params and momentum at
  rtol 1e-5, atol 1e-6 (one SGD step moves each weight by 0.1 × its
  gradient, whose small entries carry f32 rounding), the step counter
  exactly;
- `build_prefill_case` and `build_decode_case`'s functions at a small
  input shape against the reference's, on gemma2-27b's smoke stack
  (scanned: one group of (local, global)) and whisper-tiny's (unscanned):
  logits at 1e-5 and tokens equal;
- the cases' arguments (this rank's ``meta`` tensors against the
  reference's `ShapeDtypeStruct`s: shapes and dtypes, leaf for leaf),
  specs, ``donate_argnums`` and ``meta``, for the three kinds;
- `sample_batch`'s shapes, dtypes and token range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.convert import tree_from_numpy
from repro_torch.launch import steps
from repro_torch.launch import mesh as pmesh
from repro_torch.models import scan

KEY = jax.random.PRNGKey(0)
RTOL = 1e-4
P_RTOL, P_ATOL = 1e-5, 1e-6
TOL = 1e-5
# a prompt of 16 into caches of 24, then decode steps
SMALL = steps.InputShape("small_decode", 24, 2, "decode")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """A port tree's tensors in `jax.tree_util.tree_leaves`' order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for v in tree for t in _leaves(v)]


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_reference(microbatch):
    jcfg = jget_smoke_config("stablelm-3b")
    pcfg = configs.get_smoke_config("stablelm-3b")
    jm, pm = jmesh.make_host_mesh(), pmesh.make_host_mesh("cpu")
    assert pmesh.n_clients(pm, pcfg) == jmesh.n_clients(jm, jcfg) == 1
    jparams = jsteps.init_stacked_params(KEY, jcfg, 1)
    jopt = jsteps.make_optimizer(jcfg).init(jparams)
    toks = np.random.default_rng(0).integers(
        0, pcfg.vocab_size, (1, 4, 16)).astype(np.int32)
    w, assign = np.ones((1, 1), np.float32), np.zeros((1,), np.int32)
    jstep = jax.jit(jsteps.build_train_step(jcfg, jm, microbatch=microbatch))
    jp, jo, jmet = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)},
                         jnp.asarray(w), jnp.asarray(assign))

    params = tree_from_numpy(_jtree(jparams), "cpu")
    opt_state = steps.init_opt_state(steps.make_optimizer(pcfg), params)
    step = steps.build_train_step(pcfg, pm, microbatch=microbatch)
    pp, po, pmet = step(params, opt_state,
                        {"tokens": torch.from_numpy(toks)},
                        torch.from_numpy(w), torch.from_numpy(assign))
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(pmet[k]), float(jmet[k]), rtol=RTOL,
                                   err_msg=k)
    assert (jax.tree_util.tree_structure(_jtree(jp))
            == jax.tree_util.tree_structure(_jtree(jparams)))
    keys = sorted(scan.flat_params(pp))
    for k, a, b in zip(keys, _leaves(pp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=k)
    for k, a, b in zip(keys, _leaves(po["mu"]),
                       jax.tree_util.tree_leaves(jo["mu"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=P_RTOL, atol=P_ATOL,
                                   err_msg=f"mu {k}")
    assert int(po["step"]) == int(jo["step"]) == 1


@pytest.mark.parametrize("arch", ["gemma2-27b", "whisper-tiny"])
def test_serve_case_functions_match_reference(arch):
    jcfg, pcfg = jget_smoke_config(arch), configs.get_smoke_config(arch)
    jm, pm = jmesh.make_host_mesh(), pmesh.make_host_mesh("cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, pcfg.vocab_size,
                                    (2, 16)).astype(np.int32)}
    if pcfg.family == "audio":
        batch["audio_embeds"] = rng.standard_normal(
            (2, pcfg.encoder.n_ctx, pcfg.d_model)).astype(np.float32)
    jparams = jsteps.init_model_params(KEY, jcfg)
    params = tree_from_numpy(_jtree(jparams), "cpu")

    jpre = jsteps.build_prefill_case(jcfg, jm, SMALL)
    ppre = steps.build_prefill_case(pcfg, pm, SMALL)
    jl, jc = jax.jit(jpre.fn)(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    pl, pc = ppre.fn(params, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=TOL, atol=TOL)
    jdec = jax.jit(jsteps.build_decode_case(jcfg, jm, SMALL).fn)
    pdec = steps.build_decode_case(pcfg, pm, SMALL).fn
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    pt = pl.argmax(-1).to(torch.int32)
    for i in range(2):
        pos = 16 + i
        jl, jc = jdec(jparams, jc, jt, jnp.full((2,), pos, jnp.int32))
        pl, pc = pdec(params, pc, pt, pos)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        pt = pl.argmax(-1).to(torch.int32)
        assert np.array_equal(_np(pt), np.asarray(jt))


def _same_structs(got, want):
    g, w = _leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


def _specs(records):
    """The specs of a `to_shardings` record tree, as tuples in leaf order
    (None kept as None)."""
    if records is None:
        return [None]
    if isinstance(records, tuple) and len(records) == 2 and \
            isinstance(records[0], pmesh.Mesh):
        return [tuple(records[1])]
    if isinstance(records, dict):
        return [s for k in sorted(records) for s in _specs(records[k])]
    return [s for v in records for s in _specs(v)]


def _jspecs(shardings):
    if shardings is None:
        return [None]
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(shardings)]


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k",
                                  "long_500k"])
def test_cases_match_reference(kind):
    arch = "olmoe-1b-7b" if kind == "train_4k" else "zamba2-2.7b"
    jcfg, pcfg = jget_smoke_config(arch), configs.get_smoke_config(arch)
    jm, pm = jmesh.make_host_mesh(), pmesh.make_host_mesh("cpu")
    jcase = jsteps.build_case(jcfg, jm, kind)
    pcase = steps.build_case(pcfg, pm, kind)
    assert pcase.donate_argnums == jcase.donate_argnums
    assert pcase.meta == jcase.meta
    if kind.startswith("decode") or kind == "long_500k":
        # the position is an int, the last slot
        assert pcase.args[3] == steps.INPUT_SHAPES[kind].seq_len - 1
        _same_structs(pcase.args[:3], jcase.args[:3])
    else:
        _same_structs(pcase.args, jcase.args)
    got_in, want_in = _specs(pcase.in_shardings), _jspecs(jcase.in_shardings)
    assert got_in == want_in
    got_out = [s for s in _specs(pcase.out_shardings) if s is not None]
    assert got_out == [s for s in _jspecs(jcase.out_shardings)
                       if s is not None]


def test_sample_batch():
    cfg = configs.get_smoke_config("paligemma-3b")
    shape = steps.InputShape("t", 24, 4, "train")
    struct = steps.train_batch_struct(cfg, shape, 2)
    out = steps.sample_batch(torch.Generator().manual_seed(0), struct,
                             cfg.vocab_size)
    for k, s in struct.items():
        assert out[k].shape == s.shape and out[k].dtype == s.dtype
        assert out[k].device.type == "cpu"
    assert out["tokens"].shape == (2, 2, 24 - cfg.vision.n_tokens)
    assert 0 <= int(out["tokens"].min()) and \
        int(out["tokens"].max()) < cfg.vocab_size
