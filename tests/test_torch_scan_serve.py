"""The port's scanned serving path (`models/scan.py`'s `stack_caches`,
`prefill`, `decode_step`) and ``remat``, on the CPU.

Seven smoke stacks (the reference's `reduced` configs at 4 layers, so
that the scan runs several groups: stablelm-3b and olmoe-1b-7b 4 groups
of one layer, gemma2-27b 2 groups of (local, global), deepseek-v3-671b
one dense prefix layer and 3 groups, zamba2-2.7b 2 groups of (SSM,
shared attention), mamba2-780m 4 SSM groups, paligemma-3b 4 groups
under an 8-token image prefix): the same numpy params (the reference's
scanned tree) and tokens go through

- the port's scanned `prefill` and 2 `decode_step`s against its own
  unrolled `transformer.prefill` / `decode_step` on the unstacked views
  of the same params: logits and caches bitwise (each group runs the
  very ops of its layer, on tensors of the same strides);
- the same against the reference's jitted `scan.prefill` /
  `scan.decode_step`: logits within ``TOL`` = 1e-5 (f32; the two
  packages' GEMMs and reductions sum in other orders), tokens equal,
  the caches' positions equal.

Then gemma2-27b under ``long_context`` (rings of 64 under a 80-token
prompt, so they wrap), `stack_caches` against the reference's layout
field for field, the in-place rule (a decode step writes an attention
slot into its stack and returns that stack; it never overwrites an
SSM slot it was handed: the old slot, kept, is unchanged after the
step), and ``remat=True`` on stablelm-3b and zamba2-2.7b (a shared
attention block among the recomputed layers): the loss bitwise
``remat=False``'s, its gradients under `torch.func.grad` and
`vmap(grad)` against `jax.grad` of the reference's remat loss at
`tests/test_scan.py`'s tolerance (rtol 2e-4, atol 2e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch import steps as jsteps
from repro.models import scan as jscan
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import tree_from_numpy
from repro_torch.models import scan
from repro_torch.models import transformer as T
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache

ARCHS = ("stablelm-3b", "gemma2-27b", "olmoe-1b-7b", "deepseek-v3-671b",
         "zamba2-2.7b", "mamba2-780m", "paligemma-3b")
N_LAYERS = 4
B, S, CACHE, STEPS = 2, 12, 24, 2
TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
KEY = jax.random.PRNGKey(0)


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


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget_smoke_config(arch), n_layers=N_LAYERS,
                               **kw)
    pcfg = dataclasses.replace(configs.get_smoke_config(arch),
                               n_layers=N_LAYERS, **kw)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert scan.layer_grouping(pcfg) == jscan.layer_grouping(jcfg)
    return jcfg, pcfg


def _batch(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision.n_tokens, cfg.vision.embed_dim)).astype(np.float32)
    return out


def _pbatch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _cache_leaves(caches):
    """(path, tensor) of a port cache tree: lists and tuples by index,
    NamedTuples by field, in `jax.tree_util.tree_leaves`' order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}.{k}")
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f, v in zip(t._fields, t):
                walk(v, f"{path}.{f}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}.{i}")
        else:
            out.append((path, t))
    walk(caches, "")
    return out


def _same_caches(a, b):
    la, lb = _cache_leaves(a), _cache_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


def _run_port(pcfg, pscan, batch, cache, long_context=False):
    """Scanned and unrolled serving on the same params: (scanned logits,
    unrolled logits, scanned caches, unrolled caches) after the prefill
    and each greedy step."""
    pb = _pbatch(batch)
    loop = scan.unstack_layer_params(pscan, pcfg)
    mk = lambda: T.make_caches(pcfg, B, cache, torch.float32,  # noqa: E731
                               long_context=long_context, device="cpu")
    sc = scan.stack_caches(mk(), pcfg)
    lc = mk()
    ls, sc = scan.prefill(pscan, pcfg, pb, sc, long_context=long_context)
    lu, lc = T.prefill(loop, pcfg, pb, lc, long_context=long_context)
    outs = [(ls, lu)]
    pos = pb["tokens"].shape[1] + (pcfg.vision.n_tokens
                                   if pcfg.family == "vlm" else 0)
    tok = ls.argmax(-1)
    for i in range(STEPS):
        p = torch.full((B,), pos + i, dtype=torch.int32)
        ls, sc = scan.decode_step(pscan, pcfg, tok, sc, p,
                                  long_context=long_context)
        lu, lc = T.decode_step(loop, pcfg, tok, lc, pos + i,
                               long_context=long_context)
        outs.append((ls, lu))
        tok = ls.argmax(-1)
    return outs, sc, lc, pos


def _run_ref(jcfg, jparams, batch, pos, cache, long_context=False):
    caches = jscan.stack_caches(jT.make_caches(
        jcfg, B, cache, jnp.float32, long_context=long_context), jcfg)
    pre = jax.jit(lambda p, b, c: jscan.prefill(p, jcfg, b, c,
                                                long_context=long_context))
    dec = jax.jit(lambda p, t, c, q: jscan.decode_step(
        p, jcfg, t, c, q, long_context=long_context))
    logits, caches = pre(jparams, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, caches)
    outs = [logits]
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(STEPS):
        logits, caches = dec(jparams, tok, caches,
                             jnp.full((B,), pos + i, jnp.int32))
        outs.append(logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return outs, caches


def _check(jcfg, pcfg, arch, long_context=False, s=S, cache=CACHE):
    jparams = jsteps.init_model_params(KEY, jcfg)
    pscan = tree_from_numpy(_jtree(jparams), "cpu")
    batch = _batch(pcfg, s=s)
    outs, sc, lc, pos = _run_port(pcfg, pscan, batch, cache, long_context)
    # the scanned path bitwise the unrolled one, logits and caches
    for ls, lu in outs:
        assert torch.equal(ls, lu)
    _same_caches(scan.unstack_caches(sc, pcfg), lc)
    # and within TOL of the reference's scanned path, the same tokens
    jouts, jcaches = _run_ref(jcfg, jparams, batch, pos, cache,
                              long_context)
    for i, ((ls, _), jl) in enumerate(zip(outs, jouts)):
        np.testing.assert_allclose(_np(ls), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"{arch} call {i}")
        assert np.array_equal(_np(ls).argmax(-1), np.asarray(jl).argmax(-1))
    got = _cache_leaves(sc)
    want = jax.tree_util.tree_leaves(jcaches)
    assert len(got) == len(want)
    for (p, x), y in zip(got, want):
        assert tuple(x.shape) == y.shape, p
        if p.endswith(".pos"):
            np.testing.assert_array_equal(_np(x), np.asarray(y), err_msg=p)


@pytest.mark.parametrize("arch", ARCHS)
def test_scanned_serving_matches_unrolled_and_reference(arch):
    _check(*_cfgs(arch), arch)


def test_scanned_long_context():
    """gemma2-27b under ``long_context``: every ring 64 slots, a prompt of
    80 (longer than the rings), then steps over the wrapped rings."""
    _check(*_cfgs("gemma2-27b"), "gemma2-27b", long_context=True, s=80,
           cache=96)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "zamba2-2.7b"])
def test_stack_caches_follows_reference_layout(arch):
    jcfg, pcfg = _cfgs(arch)
    want = jscan.stack_caches(jT.make_caches(jcfg, B, CACHE, jnp.float32),
                              jcfg)
    got = scan.stack_caches(T.make_caches(pcfg, B, CACHE, torch.float32,
                                          device="cpu"), pcfg)
    assert isinstance(got["prefix"], list)
    assert isinstance(got["scan"], tuple)
    assert len(got["prefix"]) == len(want["prefix"])
    assert len(got["scan"]) == len(want["scan"])
    for a, b in zip(got["prefix"] + list(got["scan"]),
                    want["prefix"] + list(want["scan"])):
        assert a._fields == b._fields and type(a).__name__ == \
            type(b).__name__
        for x, y in zip(a, b):
            assert tuple(x.shape) == y.shape
            np.testing.assert_array_equal(_np(x), np.asarray(y))
    # and back: one cache a layer, in layer order
    back = scan.unstack_caches(got, pcfg)
    _same_caches(back, T.make_caches(pcfg, B, CACHE, torch.float32,
                                     device="cpu"))


def test_decode_writes_rings_in_place_never_ssm_caches():
    """zamba2-2.7b: slot 0 SSM, slot 1 the shared attention.  A decode
    step returns the attention slot itself, written; the SSM slot it was
    handed keeps its values, and a new slot comes back."""
    jcfg, pcfg = _cfgs("zamba2-2.7b")
    pscan = tree_from_numpy(_jtree(jsteps.init_model_params(KEY, jcfg)),
                            "cpu")
    pb = _pbatch(_batch(pcfg))
    caches = scan.stack_caches(T.make_caches(pcfg, B, CACHE, torch.float32,
                                             device="cpu"), pcfg)
    _, caches = scan.prefill(pscan, pcfg, pb, caches)
    ssm_old, ring_old = caches["scan"]
    assert isinstance(ssm_old, SSMCache) and isinstance(ring_old, KVCache)
    kept = [t.clone() for t in ssm_old]
    ring_before = ring_old.k.clone()
    tok = torch.zeros((B, 1), dtype=torch.long)
    _, new = scan.decode_step(pscan, pcfg, tok, caches, S)
    ssm_new, ring_new = new["scan"]
    assert ring_new is ring_old
    assert not torch.equal(ring_old.k, ring_before)
    assert int(ring_old.pos[0, 0, S]) == S
    for t, k in zip(ssm_old, kept):
        assert torch.equal(t, k)
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(ssm_new, ssm_old))
    assert not torch.equal(ssm_new.state, ssm_old.state)


# ---------------------------------------------------------------------------
# remat


@pytest.mark.parametrize("arch", ["stablelm-3b", "zamba2-2.7b"])
def test_remat_loss_bitwise_and_grads_match_reference(arch):
    jcfg, pcfg = _cfgs(arch)
    jparams = jsteps.init_model_params(KEY, jcfg)
    toks = _batch(pcfg, seed=1)["tokens"]
    pscan = tree_from_numpy(_jtree(jparams), "cpu")
    flat = scan.flat_params(pscan)
    batch = {"tokens": torch.from_numpy(toks).long()}

    def loss(fp, remat):
        return scan.loss_fn(scan.nest_params(fp), pcfg, batch,
                            remat=remat)[0]

    assert torch.equal(loss(flat, True), loss(flat, False))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jscan.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)},
                                remat=True), has_aux=True)(jparams)
    np.testing.assert_allclose(float(loss(flat, True)), float(jl),
                               rtol=GRAD_RTOL)
    want = dict(zip(sorted(flat), jax.tree_util.tree_leaves(jg)))
    g = grad(loss)(flat, True)
    stacked = {k: v[None].expand((2,) + v.shape).clone()
               for k, v in flat.items()}
    gv = vmap(grad(loss), in_dims=(0, None))(stacked, True)
    for k, w in want.items():
        np.testing.assert_allclose(_np(g[k]), np.asarray(w),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
        for i in range(2):
            np.testing.assert_allclose(_np(gv[k][i]), np.asarray(w),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"vmap {i} {k}")
