"""The port's SSM and hybrid families (mamba2-780m, zamba2-2.7b) and
nemotron-4-340b against the reference, on the CPU.

`models/ssm.py` piece by piece (`_causal_conv` with and without a carry
and at the f32-carry / bf16-input promotion, `_segsum`, `ssd_scan` at S a
multiple of the chunk and not, with and without an initial state,
`ssd_decode_step`, `ssm_apply` with no cache, a prefill into a cache and
decode steps); then each family's smoke stack (the reference's own
`reduced` config: 2 layers, d_model 256, d_state 16, head_dim 16, chunk
32; zamba2's layer 1 the shared attention block): `forward` in the loop
and the scan form, `prefill` + `decode_step`, and the losses and
gradients against `jax.grad` in both forms; the params converter and the
flat-key view on a bf16 config at zamba2's published period (the f32
A_log, D and dt_bias kept beside bf16 leaves); a store file of zamba2's
byte for byte the reference's; nemotron's smoke stack (GQA, squared
ReLU, LayerNorm, untied); the smoke serve CLI, whose default is now
mamba2-780m, against ``jserve.main([])``; and one ``--federated --store
--arch mamba2-780m`` run against the reference CLI's tokens.  Each
architecture's reference runs happen once, in a module fixture.

Tolerances: the layer pieces at rtol = atol = 1e-5 (f32; the three-operand
einsums contract in another order than XLA's); model logits at 2e-4 as
tests/test_torch_lm.py; losses and gradients at rtol 1e-4, atol 1e-6 as
tests/test_torch_lm_train.py; served tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.fl.serve import DeltaStore as JDeltaStore
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import scan as jscan
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import (lm_params_from_numpy, lm_view_from_numpy,
                                 lm_view_to_numpy, tree_from_numpy)
from repro_torch.fl import DeltaStore
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import scan, ssm
from repro_torch.models import transformer as T

ARCHS = ("mamba2-780m", "zamba2-2.7b")
LAYER_TOL = 1e-5
TOL = 2e-4
RTOL, GATOL = 1e-4, 1e-6
B, S, PROMPT, CACHE = 2, 40, 37, 48        # S, PROMPT: not multiples of 32


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


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _cfgs(arch):
    jcfg, pcfg = jget_smoke_config(arch), configs.get_smoke_config(arch)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    return jcfg, pcfg


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ARCHS + ("nemotron-4-340b",))
def test_configs_and_presets_match_reference(arch):
    for smoke in (False, True):
        got = (configs.get_smoke_config(arch) if smoke
               else configs.get_config(arch))
        want = jget_smoke_config(arch) if smoke else jget_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [got.layer_kind(i) for i in range(got.n_layers)] == \
            [want.layer_kind(i) for i in range(want.n_layers)]
    assert arch in configs.ARCH_IDS
    assert arch not in configs.registry.NOT_PORTED
    for preset in ("cpu-small", "lm-100m", "full"):
        assert dataclasses.asdict(train.preset_config(arch, preset)) == \
            dataclasses.asdict(jtrain.preset_config(arch, preset))
    assert scan.layer_grouping(configs.get_config(arch)) == \
        jscan.layer_grouping(jget_config(arch))


# ---------------------------------------------------------------------------
# models/ssm.py piece by piece (mamba2's smoke widths)


@pytest.mark.parametrize("carry,dtype", [(None, "float32"),
                                         ("float32", "float32"),
                                         ("float32", "bfloat16"),
                                         ("bfloat16", "bfloat16")])
def test_causal_conv_matches_reference(carry, dtype):
    """With no carry (zeros in x's dtype) and with one; an f32 carry with
    bf16 inputs convolves in f32, as ``jnp.concatenate`` promotes."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 7, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) / 2).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    c = None if carry is None else rng.standard_normal(
        (B, 3, 24)).astype(np.float32)
    jd = getattr(jnp, dtype)
    jx, jw, jb = (jnp.asarray(a, jd) for a in (x, w, bias))
    jc = None if c is None else jnp.asarray(c, getattr(jnp, carry))
    want, wcarry = jssm._causal_conv(jx, jw, jb, jc)
    conv = lambda a: tree_from_numpy(np.asarray(a), "cpu")  # noqa: E731
    got, gcarry = ssm._causal_conv(conv(jx), conv(jw), conv(jb),
                                   None if jc is None else conv(jc))
    assert str(got.dtype)[6:] == str(want.dtype) == (
        "float32" if "float32" in (dtype, carry) else "bfloat16")
    assert gcarry.dtype == conv(wcarry).dtype
    tol = LAYER_TOL if got.dtype == torch.float32 else 2e-2
    _close(got, want, tol)
    np.testing.assert_array_equal(_np(gcarry), _np(wcarry))


def test_segsum_matches_reference_and_its_gradient_stays_finite():
    """The forward equals the reference's, at the smoke chunk and at the
    published chunk of 256 on a decay that overflows the reference's
    unmasked exp; the port's gradient there is finite (the reference's
    is inf·0, ROADMAP Queue 3)."""
    rng = np.random.default_rng(2)
    for c, scale in ((32, 0.1), (256, 1.0)):
        dA = -(rng.random((2, c, 3)) * scale).astype(np.float32)
        want = np.asarray(jssm._segsum(jnp.asarray(dA)))
        got = ssm._segsum(torch.from_numpy(dA))
        _close(got, want, LAYER_TOL)
        assert np.all(np.triu(np.ones((c, c)), 1)[None, None] * want == 0)
    g = grad(lambda a: ssm._segsum(a).sum())(torch.from_numpy(dA))
    assert torch.isfinite(g).all()
    jg = jax.grad(lambda a: jssm._segsum(a).sum())(jnp.asarray(dA))
    assert not np.isfinite(np.asarray(jg)).all()


@pytest.mark.parametrize("s", [64, 45])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_matches_reference(s, with_init):
    rng = np.random.default_rng(s)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (rng.random((b, s, h)) * 0.2).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    Bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_init else None
    y, st = jax.jit(jssm.ssd_scan, static_argnums=5)(
        x, dt, A, Bm, Cm, 32, init)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    gy, gst = ssm.ssd_scan(t(x), t(dt), t(A), t(Bm), t(Cm), 32, t(init))
    assert gy.shape == (b, s, h, p) and gst.shape == (b, h, p, n)
    _close(gy, y, LAYER_TOL)
    _close(gst, st, LAYER_TOL)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = (rng.random((b, h)) * 0.2).astype(np.float32)
    A = -np.linspace(1.0, 4.0, h).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, g, n)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    y, new = jssm.ssd_decode_step(x, dt, A, Bm, Cm, st)
    gy, gnew = ssm.ssd_decode_step(*(torch.from_numpy(a) for a in
                                     (x, dt, A, Bm, Cm, st)))
    _close(gy, y, LAYER_TOL)
    _close(gnew, new, LAYER_TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_ssm_apply_matches_reference(cached):
    """No cache (the training path), and a prefill of 37 tokens into a
    cache followed by decode steps (the one-token state update)."""
    jcfg, pcfg = _cfgs("mamba2-780m")
    params = jssm.ssm_init(jax.random.PRNGKey(0), jcfg)
    pparams = tree_from_numpy(_jtree(params), "cpu")
    assert {k: v.dtype for k, v in pparams.items()} == {
        k: getattr(torch, str(v.dtype)) for k, v in params.items()}
    x = np.random.default_rng(4).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    if not cached:
        want, wc = jax.jit(lambda p, x: jssm.ssm_apply(p, jcfg, x))(params, x)
        got, gc = ssm.ssm_apply(pparams, pcfg, torch.from_numpy(x))
        _close(got, want, LAYER_TOL)
        for g, w in zip(gc, wc):
            _close(g, w, LAYER_TOL)
        return
    jc = jssm.init_ssm_cache(jcfg, B, jnp.float32)
    pc = ssm.init_ssm_cache(pcfg, B, torch.float32, "cpu")
    assert [tuple(t.shape) for t in pc] == [t.shape for t in jc]
    step = jax.jit(lambda p, x, c, d: jssm.ssm_apply(p, jcfg, x, c, decode=d),
                   static_argnums=3)
    spans = [(0, PROMPT)] + [(i, i + 1) for i in range(PROMPT, S)]
    for lo, hi in spans:
        decode = hi - lo == 1
        want, jc = step(params, jnp.asarray(x[:, lo:hi]), jc, decode)
        got, pc = ssm.ssm_apply(pparams, pcfg, torch.from_numpy(x[:, lo:hi]),
                                pc, decode=decode)
        _close(got, want, LAYER_TOL, f"positions {lo}:{hi}")
        for g, w in zip(pc, jc):
            assert g.dtype == torch.float32
            _close(g, w, LAYER_TOL, f"cache at {lo}:{hi}")
    with pytest.raises(ValueError, match="one token"):
        ssm.ssm_apply(pparams, pcfg, torch.from_numpy(x[:, :2]), pc,
                      decode=True)


# ---------------------------------------------------------------------------
# the smoke stacks: one reference run per architecture


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """The reference's smoke-config runs of one architecture: forward
    logits (loop and scan form), prefill + decode-step logits, and the
    losses and gradients of both forms."""
    arch = request.param
    jcfg, pcfg = _cfgs(arch)
    loop = jT.init_params(jax.random.PRNGKey(7), jcfg)
    scanned = jscan.stack_layer_params(loop, jcfg)
    toks = jnp.asarray(_tokens(jcfg, B, S, seed=8))
    out = {"arch": arch, "jcfg": jcfg, "pcfg": pcfg, "loop": loop,
           "scanned": scanned, "toks": toks}
    out["logits"] = jax.jit(lambda p: jT.forward(p, jcfg, {"tokens": toks})[0]
                            )(loop)
    out["scan_logits"] = jax.jit(lambda p: jscan.forward(
        p, jcfg, {"tokens": toks})[0])(scanned)
    caches = jT.make_caches(jcfg, B, CACHE, jnp.float32)
    logits, caches = jax.jit(lambda p, t, c: jT.prefill(
        p, jcfg, {"tokens": t}, c))(loop, toks[:, :PROMPT], caches)
    steps = [logits]
    decode = jax.jit(lambda p, t, c, pos: jT.decode_step(p, jcfg, t, c, pos))
    for i in range(PROMPT, S):
        logits, caches = decode(loop, toks[:, i:i + 1], caches,
                                jnp.full((B,), i, jnp.int32))
        steps.append(logits)
    out["steps"], out["caches"] = steps, caches
    for form, fn, p in (("loop", jT.loss_fn, loop),
                        ("scan", jscan.loss_fn, scanned)):
        out[form + "_grad"] = jax.jit(jax.value_and_grad(
            lambda p: fn(p, jcfg, {"tokens": toks}), has_aux=True))(p)
    return out


def _ptoks(ref, lo=0, hi=None):
    return torch.from_numpy(np.array(ref["toks"])[:, lo:hi]).long()


def test_init_layout_matches_reference(ref):
    """The port's own init gives the reference's tree: the same keys,
    shapes and dtypes (``shared_attn`` on the hybrid, SSM layers with
    ``norm1`` and ``ssm`` only)."""
    pcfg = ref["pcfg"]
    mine = T.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    want = scan.flat_params(_jtree(ref["loop"]))
    got = scan.flat_params(mine)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype)[6:] == str(want[k].dtype), k
    assert ("shared_attn" in mine) == (pcfg.family == "hybrid")


def test_forward_and_scan_logits_match_reference(ref):
    pcfg = ref["pcfg"]
    loop = lm_params_from_numpy(_jtree(ref["loop"]), pcfg, "cpu")
    got, aux = T.forward(loop, pcfg, {"tokens": _ptoks(ref)})
    _close(got, ref["logits"])
    assert float(aux) == 0.0
    from_scan = lm_params_from_numpy(_jtree(ref["scanned"]), pcfg, "cpu")
    _close(T.forward(from_scan, pcfg, {"tokens": _ptoks(ref)})[0],
           ref["scan_logits"])
    view = scan.nest_params(lm_view_from_numpy(_jtree(ref["scanned"]),
                                               "cpu"))
    hidden, _ = scan.forward_hidden(view, pcfg, {"tokens": _ptoks(ref)})
    _close(T._unembed(view, pcfg, hidden), ref["scan_logits"])


def test_prefill_and_decode_match_reference(ref):
    """The reference's `test_decode_matches_forward` shape: a prompt of
    37 into caches of 48, then decode steps to position 39."""
    pcfg = ref["pcfg"]
    params = lm_params_from_numpy(_jtree(ref["loop"]), pcfg, "cpu")
    caches = T.make_caches(pcfg, B, CACHE, torch.float32, device="cpu")
    kinds = [type(c).__name__ for c in caches]
    assert kinds == ["SSMCache" if pcfg.layer_kind(i) == "ssm" else "KVCache"
                     for i in range(pcfg.n_layers)]
    logits, caches = T.prefill(params, pcfg, {"tokens": _ptoks(ref, 0,
                                                               PROMPT)},
                               caches)
    got = [logits]
    for i in range(PROMPT, S):
        logits, caches = T.decode_step(params, pcfg, _ptoks(ref, i, i + 1),
                                       caches, i)
        got.append(logits)
    for i, (g, w) in enumerate(zip(got, ref["steps"])):
        _close(g, w, msg=f"step {i}")
    for g, w in zip(caches, ref["caches"]):
        if isinstance(g, ssm.SSMCache):
            for a, b in zip(g, w):
                _close(a, b)
    # the last decode step reproduces the full forward's last position
    _close(got[-1][:, -1], np.asarray(ref["logits"])[:, -1])


def test_losses_and_gradients_match_jax_grad(ref):
    """The loop form and the scanned layout's flat-key view (the training
    engine's params) against `jax.grad`."""
    pcfg = ref["pcfg"]
    batch = {"tokens": _ptoks(ref)}
    (_, jm), jg = ref["loop_grad"]
    ploop = lm_params_from_numpy(_jtree(ref["loop"]), pcfg, "cpu")
    pg, pm = grad(lambda p: T.loss_fn(p, pcfg, batch), has_aux=True)(ploop)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=RTOL)
    want = scan.flat_params(_jtree(jg))
    got = scan.flat_params(pg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(_np(got[k]), v, rtol=RTOL, atol=GATOL,
                                   err_msg=k)
    (sl, _), sg = ref["scan_grad"]
    view = lm_view_from_numpy(_jtree(ref["scanned"]), "cpu")
    loss_fn, _ = train.lm_fns(pcfg)
    vg, vl = grad(loss_fn, has_aux=True)(view, {"x": batch["tokens"]})
    np.testing.assert_allclose(float(vl["loss"]), float(sl), rtol=RTOL)
    for k, v in scan.flat_params(_jtree(sg)).items():
        np.testing.assert_allclose(_np(vg[k]), v, rtol=RTOL, atol=GATOL,
                                   err_msg=k)


def test_vmapped_decode_equals_per_user_generate(ref):
    """The per-user decode under `torch.func.vmap` (the SSM caches are
    new tensors each step, so they take the users' batch dim) against
    `generate` per user."""
    pcfg = ref["pcfg"]
    flat = lm_view_from_numpy(_jtree(ref["scanned"]), "cpu")
    gen = torch.Generator().manual_seed(2)
    stacked = {k: v[None] + 0.01 * torch.randn((3,) + v.shape, generator=gen)
               for k, v in flat.items()}
    prompts = torch.randint(0, pcfg.vocab_size, (3, 33), generator=gen)
    n, clen = 4, 40
    toks = vmap(serve.build_decode_one(pcfg, 33, n, clen))(stacked, prompts)
    for i in range(3):
        mine = scan.unstack_layer_params(scan.nest_params(
            {k: v[i] for k, v in stacked.items()}), pcfg)
        res = serve.generate(mine, pcfg, prompts[i:i + 1], n, clen)
        np.testing.assert_array_equal(toks[i].numpy(), res.tokens[0].numpy())


# ---------------------------------------------------------------------------
# mixed dtypes: the converter, the flat-key view and the store


def _zamba2_period_bf16():
    """zamba2's smoke widths at its published period (attn_every 6, 12
    layers: two groups of five SSM layers and the shared attention), in
    bf16."""
    fix = lambda c: dataclasses.replace(  # noqa: E731
        c, n_layers=12, param_dtype="bfloat16", compute_dtype="bfloat16",
        hybrid=dataclasses.replace(c.hybrid, attn_every=6))
    jcfg, pcfg = (fix(c) for c in _cfgs("zamba2-2.7b"))
    assert jscan.layer_grouping(jcfg) == scan.layer_grouping(pcfg) == \
        (0, 6, 2)
    return jcfg, pcfg


def test_converter_keeps_each_leafs_dtype_at_zamba2s_period():
    jcfg, pcfg = _zamba2_period_bf16()
    loop = jT.init_params(jax.random.PRNGKey(1), jcfg)
    scanned = _jtree(jscan.stack_layer_params(loop, jcfg))
    dtypes = {k: v.dtype for k, v in scan.flat_params(scanned).items()}
    assert {str(d) for d in dtypes.values()} == {"float32", "bfloat16"}
    assert all(str(d) == "float32" for k, d in dtypes.items()
               if k.rsplit(".", 1)[-1] in ("A_log", "D", "dt_bias"))
    params = lm_params_from_numpy(scanned, pcfg, "cpu")
    want = scan.flat_params(_jtree(loop))
    for k, v in scan.flat_params(params).items():
        assert str(v.dtype)[6:] == str(want[k].dtype), k
        np.testing.assert_array_equal(_np(v), _np(want[k].astype(np.float32)),
                                      err_msg=k)
    view = lm_view_from_numpy(scanned, "cpu")
    assert {k: str(v.dtype)[6:] for k, v in view.items()} == \
        {k: str(d) for k, d in dtypes.items()}
    back = lm_view_to_numpy(view, pcfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(scanned)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(scanned)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the port's own stack keeps them too
    restacked = scan.flat_params(scan.stack_layer_params(params, pcfg))
    assert {k: str(v.dtype)[6:] for k, v in restacked.items()} == \
        {k: str(d) for k, d in dtypes.items()}
    assert ml_dtypes.bfloat16 in {d.type for d in dtypes.values()}


def test_store_file_of_zamba2_matches_reference_byte_for_byte(tmp_path):
    """A `DeltaStore` of three users of zamba2 (its shared attention block
    and mixed-dtype SSM leaves in the template) written by each package:
    the same bytes, and each loads the other's."""
    jcfg = jtrain.preset_config("zamba2-2.7b", "cpu-small")
    params = jsteps.init_model_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(6)
    stacked = jax.tree_util.tree_map(
        lambda l: (np.asarray(l)[None] + 0.02 * rng.standard_normal(
            (3,) + l.shape)).astype(np.asarray(l).dtype), params)
    want = tmp_path / "want.msgpack"
    got = tmp_path / "got.msgpack"
    JDeltaStore.build(stacked, assignment=[0, 0, 1]).save(str(want))
    store = DeltaStore.build(lm_view_from_numpy(stacked, "cpu"),
                             assignment=[0, 0, 1], device="cpu")
    assert "shared_attn" in scan.nest_params(store.template)
    store.save(str(got))
    assert got.read_bytes() == want.read_bytes()
    back = DeltaStore.load(str(want), device="cpu")
    assert torch.equal(back.params_flat(), store.params_flat())


# ---------------------------------------------------------------------------
# nemotron-4-340b's smoke stack


def test_nemotron_stack_matches_reference():
    """GQA (4 query heads on 4 KV heads at smoke widths), squared-ReLU
    MLP, LayerNorm, untied head: prefill + decode-step logits and the
    loss with its gradients against `jax.grad`."""
    jcfg, pcfg = _cfgs("nemotron-4-340b")
    assert (pcfg.activation, pcfg.gated_mlp, pcfg.norm,
            pcfg.tie_embeddings) == ("relu2", False, "layernorm", False)
    loop = jT.init_params(jax.random.PRNGKey(5), jcfg)
    params = lm_params_from_numpy(_jtree(loop), pcfg, "cpu")
    toks = _tokens(jcfg, B, S, seed=9)
    jc = jT.make_caches(jcfg, B, CACHE, jnp.float32)
    want, jc = jax.jit(lambda p, t, c: jT.prefill(p, jcfg, {"tokens": t}, c))(
        loop, jnp.asarray(toks[:, :PROMPT]), jc)
    pc = T.make_caches(pcfg, B, CACHE, torch.float32, device="cpu")
    got, pc = T.prefill(params, pcfg, {"tokens": torch.from_numpy(
        toks[:, :PROMPT]).long()}, pc)
    _close(got, want)
    decode = jax.jit(lambda p, t, c, pos: jT.decode_step(p, jcfg, t, c, pos))
    for i in range(PROMPT, S):
        want, jc = decode(loop, jnp.asarray(toks[:, i:i + 1]), jc,
                          jnp.full((B,), i, jnp.int32))
        got, pc = T.decode_step(params, pcfg, torch.from_numpy(
            toks[:, i:i + 1]).long(), pc, i)
        _close(got, want, msg=f"position {i}")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(loop)
    pg, pm = grad(lambda p: T.loss_fn(
        p, pcfg, {"tokens": torch.from_numpy(toks).long()}),
        has_aux=True)(params)
    np.testing.assert_allclose(float(pm["loss"]), float(jl), rtol=RTOL)
    got = scan.flat_params(pg)
    for k, v in scan.flat_params(_jtree(jg)).items():
        np.testing.assert_allclose(_np(got[k]), v, rtol=RTOL, atol=GATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the CLIs


def test_smoke_serve_cli_default_matches_reference(capsys):
    """No ``--arch``: both CLIs serve mamba2-780m's smoke config.  The
    reference CLI's tokens (its defaults: batch 4, prompt 32, 16 tokens,
    cache 128) equal `generate`'s on the reference's params and prompt,
    and the port's CLI with no ``--arch`` is `generate` on mamba2's
    smoke config."""
    want = jserve.main([])
    jcfg = jget_smoke_config("mamba2-780m")
    kparams, ktok, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    params = jsteps.init_model_params(kparams, jcfg)
    prompt = jax.random.randint(ktok, (4, 32), 0, jcfg.vocab_size)
    pcfg = configs.get_smoke_config("mamba2-780m")
    res = serve.generate(lm_params_from_numpy(_jtree(params), pcfg, "cpu"),
                         pcfg, torch.tensor(np.asarray(prompt)).long(), 16,
                         128)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    capsys.readouterr()

    got = serve.main(["--device", "cpu", "--tokens", "3"])
    assert "prefill 32 tokens x4" in capsys.readouterr().out
    mine = T.init_params(torch.Generator().manual_seed(0), pcfg,
                         device="cpu")
    prompt = torch.randint(0, pcfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(
        got.numpy(), serve.generate(mine, pcfg, prompt, 3, 128).tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_families(arch, capsys):
    """`launch.train`'s CLI at cpu-small: vmap(grad) over the clients
    through the SSM (and shared attention) layers."""
    n0 = dict(ops.LAUNCHES)
    loss = train.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                       "--clients", "2", "--pool", "5", "--seq", "8",
                       "--batch", "2", "--placement", "host",
                       "--algorithm", "fedavg"])
    assert np.isfinite(loss)
    assert f"arch={arch}" in capsys.readouterr().out
    assert dict(ops.LAUNCHES) == n0          # the CPU launches no kernel


def test_federated_cli_matches_reference_cli(tmp_path, capsys):
    """``--federated --store --arch mamba2-780m``: the reference's CLI and
    the port's serve one store file (the reference's, at the cpu-small
    preset) with the reference's per-user prompts, and print the same
    served tokens."""
    arch = "mamba2-780m"
    jcfg = jtrain.preset_config(arch, "cpu-small")
    params = jsteps.init_model_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(6)
    stacked = jax.tree_util.tree_map(
        lambda l: (np.asarray(l)[None] + 0.02 * rng.standard_normal(
            (3,) + l.shape)).astype(np.float32), params)
    path = str(tmp_path / "store.msgpack")
    JDeltaStore.build(stacked, assignment=[0, 0, 1]).save(path)
    argv = ["--federated", "--arch", arch, "--store", path, "--requests",
            "4", "--tokens", "3", "--prompt-len", "6", "--max-batch", "4",
            "--seed", "1"]
    want = jserve.main(argv)
    want_text = capsys.readouterr().out
    kreq = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    prompts = {u: np.asarray(jax.random.randint(
        jax.random.fold_in(kreq, u), (6,), 0, jcfg.vocab_size,
        dtype=jnp.int32)) for u in range(3)}
    got = serve.main(argv + ["--device", "cpu"], prompts=prompts)
    got_text = capsys.readouterr().out
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    lines = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                       if ln.startswith(("loaded store", "user "))]
    assert lines(got_text) == lines(want_text)
    assert "parity anchor OK" in got_text
