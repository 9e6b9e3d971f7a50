"""The port's prefix-LM masks (paligemma-3b, the vlm family), its
``long_context`` serving mode and sequence-parallel decode, against the
reference on the CPU.

The flash op's plain versions (`flash_attention_ref`,
`flash_decode_ref`) with ``prefix_len`` against the reference's
`_sdpa_chunked` / `mask_bias` (the Pallas kernel has no prefix), windows
with a prefix included; the paligemma-3b smoke stack (8 vision tokens of
width 64): `forward`, `loss_fn` (loop and scanned layouts), a prefill of
the image prefix and a 24-token prompt and 4 greedy decode steps at
positions 8 + 24 + i, and `launch.serve.generate`; gemma2-27b's smoke
under ``long_context=True`` (rings of ``long_context_window`` 64, a
96-token prompt longer than them, so the global ring wraps every step);
``seq_parallel`` on equal to off, and to the reference under a
one-device mesh with axis ``"data"``; the smoke, training and
``--federated`` CLIs on paligemma.  The same numpy params and inputs go
through both; the reference runs jitted.  Tolerances: a single attention
at rtol = atol = 1e-5, the stacks at 2e-4 (tests/test_torch_lm.py's),
losses at rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import attention as jattn
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, train
from repro_torch.models import scan
from repro_torch.models import transformer as T

ARCH = "paligemma-3b"
LAYER_TOL = 1e-5
TOL = 2e-4
RTOL = 1e-4


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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# (Sq, Sk, prefix, window, G): the prefix inside, at the end of and past
# the keys; queries at the end of the keys (a decode-sized Sq too); a
# window that cuts the prefix (it is not relaxed for prefix keys)
PREFIX_CASES = [(40, 40, 8, None, 1), (40, 40, 40, None, 2),
                (24, 40, 30, None, 4), (3, 40, 50, None, 2),
                (40, 40, 30, 12, 2), (16, 16, 8, 5, 1)]


@pytest.mark.parametrize("sq,sk,prefix,window,group", PREFIX_CASES)
def test_flash_refs_prefix_match_reference_mask(sq, sk, prefix, window,
                                                group):
    rng = np.random.default_rng(sq + sk + prefix)
    kh, hd = 2, 16
    q = rng.standard_normal((2, sq, kh * group, hd)).astype(np.float32)
    k = rng.standard_normal((2, sk, kh, hd)).astype(np.float32)
    v = rng.standard_normal((2, sk, kh, hd)).astype(np.float32)

    @jax.jit
    def want_fn(q, k, v):
        q_pos = jnp.broadcast_to(jnp.arange(sk - sq, sk), (2, sq))
        k_pos = jnp.broadcast_to(jnp.arange(sk), (2, sk))
        return jattn._sdpa_chunked(q, k, v, q_pos, k_pos, kind="causal",
                                   window=window, prefix_len=prefix,
                                   cap=30.0, cdtype=jnp.float32)

    want = np.asarray(want_fn(q, k, v)).transpose(0, 2, 1, 3)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    kw = dict(causal=True, window=window, softcap=30.0, prefix_len=prefix)
    _close(ref.flash_attention_ref(qt, kt, vt, **kw), want, LAYER_TOL)
    _close(ops.flash_attention(qt, kt, vt, **kw), want, LAYER_TOL)
    for n_split in (1, 3, sk):
        _close(ref.flash_decode_ref(qt, kt, vt, n_split=n_split, **kw),
               want, LAYER_TOL)
    assert torch.equal(ref.flash_attention_ref(qt, kt, vt, causal=True),
                       ref.flash_attention_ref(qt, kt, vt, causal=True,
                                               prefix_len=0))


# ---------------------------------------------------------------------------
# the paligemma-3b smoke stack


@pytest.fixture(scope="module")
def vlm():
    jcfg, pcfg = jget_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    params = jT.init_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(6)
    b, prompt, steps, cache_len = 2, 24, 4, 40
    n_vis = jcfg.vision.n_tokens
    vision = rng.standard_normal((b, n_vis, jcfg.vision.embed_dim)
                                 ).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (b, prompt)).astype(np.int32)
    batch = {"vision_embeds": jnp.asarray(vision),
             "tokens": jnp.asarray(toks)}

    @jax.jit
    def train_side(p, bt):
        logits, _ = jT.forward(p, jcfg, bt)
        return logits, jT.loss_fn(p, jcfg, bt)[0]

    logits, loss = train_side(params, batch)
    c = jT.make_caches(jcfg, b, cache_len, jnp.float32)
    out, c = jax.jit(lambda p, bt, c: jT.prefill(p, jcfg, bt, c))(
        params, batch, c)
    step = jax.jit(lambda p, t, c, pos: jT.decode_step(p, jcfg, t, c, pos))
    outs, greedy = [out], []
    for i in range(steps):
        tok = jnp.argmax(out[:, -1], axis=-1)[:, None].astype(jnp.int32)
        greedy.append(np.asarray(tok))
        out, c = step(params, tok, c, jnp.full((b,), n_vis + prompt + i,
                                                jnp.int32))
        outs.append(out)
    return dict(jcfg=jcfg, pcfg=pcfg, vision=vision, toks=toks,
                steps=steps, cache_len=cache_len, logits=np.asarray(logits),
                loss=float(loss), want=[np.asarray(o) for o in outs],
                greedy=np.concatenate(greedy, axis=1), params=params,
                pparams=lm_params_from_numpy(_jtree(params), pcfg, "cpu"))


def _batch(vlm):
    return {"vision_embeds": torch.from_numpy(vlm["vision"]),
            "tokens": torch.from_numpy(vlm["toks"]).long()}


def test_forward_and_losses_match_reference(vlm):
    """The image prefix projected (not scaled) before the scaled text,
    bidirectional under the causal mask; the loss over the text only, in
    the loop and the scanned layout."""
    pcfg, pp = vlm["pcfg"], vlm["pparams"]
    assert pp["vision_proj"].shape == (pcfg.vision.embed_dim, pcfg.d_model)
    logits, _ = T.forward(pp, pcfg, _batch(vlm))
    _close(logits, vlm["logits"])
    loss, _ = T.loss_fn(pp, pcfg, _batch(vlm))
    np.testing.assert_allclose(float(loss), vlm["loss"], rtol=RTOL)
    stacked = scan.stack_layer_params(pp, pcfg)
    np.testing.assert_allclose(
        float(scan.loss_fn(stacked, pcfg, _batch(vlm))[0]), vlm["loss"],
        rtol=RTOL)
    # the image prefix is bidirectional: its first row sees its last
    bent = _batch(vlm)
    bent["vision_embeds"] = bent["vision_embeds"].clone()
    bent["vision_embeds"][:, -1] += 1.0
    moved, _ = T.forward(pp, pcfg, bent)
    assert float((moved[:, 0] - logits[:, 0]).abs().max()) > 1e-3


def test_prefill_and_decode_match_reference(vlm):
    """Prefill of 8 vision tokens and a 24-token prompt (one flash call a
    layer with prefix_len 8), then 4 decode steps at positions 32 + i on
    the reference's greedy tokens (prefix_len 0)."""
    pcfg, pp = vlm["pcfg"], vlm["pparams"]
    n_vis, prompt = pcfg.vision.n_tokens, vlm["toks"].shape[1]
    caches = T.make_caches(pcfg, 2, vlm["cache_len"], torch.float32,
                           device="cpu")
    calls = []
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        got, caches = T.prefill(pp, pcfg, _batch(vlm), caches)
        outs = [got]
        for i in range(vlm["steps"]):
            got, caches = T.decode_step(
                pp, pcfg, torch.from_numpy(vlm["greedy"][:, i:i + 1]).long(),
                caches, n_vis + prompt + i)
            outs.append(got)
    finally:
        ops.flash_attention = real
    for g, w in zip(outs, vlm["want"]):
        _close(g, w)
    assert [c["prefix_len"] for c in calls] == \
        [n_vis] * pcfg.n_layers + [0] * (vlm["steps"] * pcfg.n_layers)


def test_generate_and_vmapped_decode(vlm):
    """`generate` with the image: the reference's greedy tokens and
    logits; the per-user decode (`build_decode_one` under
    `torch.func.vmap`, text prompts) one flash call a layer a step for
    the batch, equal to per-user `generate`."""
    pcfg, pp = vlm["pcfg"], vlm["pparams"]
    toks = torch.from_numpy(vlm["toks"]).long()
    res = serve.generate(pp, pcfg, toks, vlm["steps"] + 1, vlm["cache_len"],
                         extra={"vision_embeds": _batch(vlm)
                                ["vision_embeds"]}, return_logits=True)
    np.testing.assert_array_equal(res.tokens[:, :-1].numpy(), vlm["greedy"])
    for g, w in zip(res.logits, vlm["want"]):
        _close(g, w[:, -1])
    flat = scan.flat_params(scan.stack_layer_params(pp, pcfg))
    one = serve.build_decode_one(pcfg, 8, 3, 16)
    batched = {k: torch.stack([v, v]) for k, v in flat.items()}
    calls = []
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        got = torch.func.vmap(one)(batched, toks[:, :8])
    finally:
        ops.flash_attention = real
    assert len(calls) == 3 * pcfg.n_layers
    for u in range(2):
        want = serve.generate(pp, pcfg, toks[u:u + 1, :8], 3, 16).tokens[0]
        np.testing.assert_array_equal(got[u].numpy(), want.numpy())


# ---------------------------------------------------------------------------
# long_context and seq_parallel on gemma2-27b's smoke config


@pytest.fixture(scope="module")
def gemma2():
    arch = "gemma2-27b"
    jcfg, pcfg = jget_smoke_config(arch), configs.get_smoke_config(arch)
    assert pcfg.attn.long_context_window == 64
    params = jT.init_params(jax.random.PRNGKey(7), jcfg)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                             (2, 100)).astype(np.int32)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, toks=toks,
                pparams=lm_params_from_numpy(_jtree(params), pcfg, "cpu"))


def _ref_serve(jcfg, params, toks, prompt, cache_len, steps, **kw):
    c = jT.make_caches(jcfg, toks.shape[0], cache_len, jnp.float32, **kw)
    rings = [x.pos.shape[1] for x in c]
    out, c = jax.jit(lambda p, t, c: jT.prefill(p, jcfg, {"tokens": t}, c,
                                                **kw))(
        params, jnp.asarray(toks[:, :prompt]), c)
    step = jax.jit(lambda p, t, c, pos: jT.decode_step(p, jcfg, t, c, pos,
                                                       **kw))
    outs = [np.asarray(out)]
    for i in range(steps):
        out, c = step(params, jnp.asarray(toks[:, prompt + i:][:, :1]), c,
                      jnp.full((toks.shape[0],), prompt + i, jnp.int32))
        outs.append(np.asarray(out))
    return outs, rings


def _port_serve(pcfg, pparams, toks, prompt, cache_len, steps, **kw):
    caches = T.make_caches(pcfg, toks.shape[0], cache_len, torch.float32,
                           device="cpu", **kw)
    rings = [c.pos.shape[1] for c in caches]
    t = torch.from_numpy(toks).long()
    out, caches = T.prefill(pparams, pcfg, {"tokens": t[:, :prompt]},
                            caches, **kw)
    outs = [out]
    for i in range(steps):
        out, caches = T.decode_step(pparams, pcfg,
                                    t[:, prompt + i:][:, :1], caches,
                                    prompt + i, **kw)
        outs.append(out)
    return outs, rings


def test_long_context_prefill_and_decode_match_reference(gemma2):
    """``long_context=True``: every layer's ring is 64 slots (the global
    layer's window goes from none to 64), the 96-token prompt takes the
    in-flight keys, and each decode step wraps the rings."""
    args = (gemma2["toks"], 96, 128, 4)
    want, jrings = _ref_serve(gemma2["jcfg"], gemma2["params"], *args,
                              long_context=True)
    got, rings = _port_serve(gemma2["pcfg"], gemma2["pparams"], *args,
                             long_context=True)
    assert rings == jrings == [64, 64]
    for g, w in zip(got, want):
        _close(g, w)
    plain, rings = _port_serve(gemma2["pcfg"], gemma2["pparams"], *args)
    assert rings == [64, 128]
    assert not torch.allclose(plain[-1], got[-1], atol=1e-3)


def test_seq_parallel_equals_off_and_reference_under_a_mesh(gemma2):
    """``seq_parallel=True``: the port's prefill and decode logits are
    bitwise those with the flag off; the reference, whose flag is a
    sharding constraint on the decode logits, runs under a one-device
    mesh with axis ``"data"`` and gives the same logits."""
    pcfg, jcfg = gemma2["pcfg"], gemma2["jcfg"]
    sp = dataclasses.replace(pcfg, attn=dataclasses.replace(
        pcfg.attn, seq_parallel=True))
    args = (gemma2["toks"], 40, 48, 3)
    off, _ = _port_serve(pcfg, gemma2["pparams"], *args)
    on, _ = _port_serve(sp, gemma2["pparams"], *args)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    jsp = dataclasses.replace(jcfg, attn=dataclasses.replace(
        jcfg.attn, seq_parallel=True))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with mesh:
        want, _ = _ref_serve(jsp, gemma2["params"], *args)
    for g, w in zip(on, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the CLIs and the registry


def test_smoke_config_and_clis(capsys):
    """The config is the reference's; the smoke serve CLI draws the image
    from its own generator and decodes after it; the training CLI and
    ``--federated`` train on the tokens alone, as the reference's LM loss
    reads them."""
    jcfg, pcfg = jget_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    got = serve.main(["--arch", ARCH, "--device", "cpu", "--tokens", "3",
                      "--batch", "2", "--prompt-len", "8"])
    assert got.shape == (2, 3)
    n0 = dict(ops.LAUNCHES)
    loss = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                       "--clients", "2", "--pool", "5", "--seq", "8",
                       "--batch", "2", "--placement", "host",
                       "--algorithm", "fedavg"])
    assert np.isfinite(loss)
    outs = serve.main(["--federated", "--device", "cpu", "--arch", ARCH,
                       "--rounds", "1", "--clients", "2", "--pool", "5",
                       "--requests", "2", "--tokens", "2", "--prompt-len",
                       "6", "--max-batch", "2"])
    assert len(outs) == 2 and "parity anchor OK" in capsys.readouterr().out
    assert dict(ops.LAUNCHES) == n0          # the CPU launches no kernel
