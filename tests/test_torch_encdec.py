"""The port's whisper encoder-decoder (audio family) against the reference,
on the CPU.

`layers.sinusoidal_positions`; cross-attention (`attention.attention`
with ``kv_input``) and the encoder's non-causal self-attention, plain
and through the flash op; and the whisper-tiny smoke stack
(`models/encdec.py`): `encode`, `decode`, `encdec_loss_fn` and its
gradient, the init layout, and a prefill plus 4 decode steps (on the
flash op's plain version, as the serving path runs on the CPU) with and
without ``long_context``, and `launch.serve.generate`; the CLIs refuse
``--federated`` / training on whisper, as the reference's do (its loss
needs the ``audio_embeds`` an LM token batch does not carry).  The same
numpy params and inputs go through both; the reference runs jitted.
Tolerances: a single attention at rtol = atol = 1e-5, the stack at 2e-4
(tests/test_torch_lm.py's), gradients at rtol 1e-4 / atol 1e-6
(tests/test_torch_lm_train.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, tree_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import attention, encdec, layers
from repro_torch.models import transformer as T

ARCH = "whisper-tiny"
LAYER_TOL = 1e-5
TOL = 2e-4
RTOL, GATOL = 1e-4, 1e-6


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


@pytest.mark.parametrize("n_ctx,dim", [(32, 256), (1500, 384), (7, 10)])
def test_sinusoidal_positions_match_reference(n_ctx, dim):
    got = layers.sinusoidal_positions(n_ctx, dim)
    assert got.dtype == torch.float32 and got.shape == (n_ctx, dim)
    _close(got, jlayers.sinusoidal_positions(n_ctx, dim), LAYER_TOL)


def test_cross_attention_and_full_mask_match_reference():
    """One layer of the smoke config: cross-attention over an encoder
    output of another length (no RoPE, full mask), and the encoder's
    non-causal self-attention, plain and through the flash op."""
    jcfg, pcfg = jget_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    cross = jattn.attn_init(jax.random.PRNGKey(1), jcfg, cross=True)
    p = lm_params_from_numpy({"layers": [_jtree(cross)] * pcfg.n_layers},
                             pcfg, "cpu")["layers"][0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, pcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 11, pcfg.d_model)).astype(np.float32)

    @jax.jit
    def both(x, enc):
        cross_out, _ = jattn.attention(
            cross, jcfg, x, jnp.broadcast_to(jnp.arange(3, 8), (2, 5)),
            kv_input=enc)
        full_out, _ = jattn.attention(
            cross, jcfg, enc, jnp.broadcast_to(jnp.arange(11), (2, 11)),
            mask_kind="full")
        return cross_out, full_out

    want, want_full = both(jnp.asarray(x), jnp.asarray(enc))
    got, c = attention.attention(p, pcfg, torch.from_numpy(x), 3,
                                 kv_input=torch.from_numpy(enc))
    assert c is None
    _close(got, want, LAYER_TOL)
    for flash in (False, True):
        got, _ = attention.attention(p, pcfg, torch.from_numpy(enc), 0,
                                     mask_kind="full", flash=flash)
        _close(got, want_full, LAYER_TOL)
    # cross-attention of an MLA config: the plain GQA projections
    mla = configs.get_smoke_config("deepseek-v3-671b")
    keys = attention.attn_init(torch.Generator(), mla, cross=True,
                               device="cpu")
    assert sorted(keys) == ["wk", "wo", "wq", "wv"]


@pytest.fixture(scope="module")
def ref():
    """The smoke config, the reference's params and inputs, and its
    jitted encode / decode / loss / gradient and serving runs."""
    jcfg, pcfg = jget_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    params = jT.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    b, prompt, steps = 2, 12, 4
    audio = rng.standard_normal((b, jcfg.encoder.n_ctx, jcfg.d_model)
                                ).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (b, prompt + steps)
                        ).astype(np.int32)
    batch = {"audio_embeds": jnp.asarray(audio),
             "tokens": jnp.asarray(toks[:, :prompt])}

    @jax.jit
    def train_side(p, bt):
        enc = jencdec.encode(p, jcfg, bt["audio_embeds"])
        logits = jencdec.decode(p, jcfg, bt["tokens"], enc)
        loss, g = jax.value_and_grad(
            lambda p_: jT.loss_fn(p_, jcfg, bt)[0])(p)
        return enc, logits, loss, g

    enc, logits, loss, g = train_side(params, batch)
    cache_len = 32
    c = jT.make_caches(jcfg, b, cache_len, jnp.float32)
    out, c = jax.jit(lambda p, bt, c: jT.prefill(p, jcfg, bt, c))(
        params, batch, c)
    step = jax.jit(lambda p, t, c, pos: jT.decode_step(p, jcfg, t, c, pos))
    outs, greedy = [out], []
    for i in range(steps):
        tok = jnp.argmax(out[:, -1], axis=-1)[:, None].astype(jnp.int32)
        greedy.append(np.asarray(tok))
        out, c = step(params, tok, c, jnp.full((b,), prompt + i, jnp.int32))
        outs.append(out)
    # long_context: the reference's audio rings are min(cache_len,
    # long_context_window) long, its windows unchanged
    rings = {lc: [x["self"].pos.shape[1] for x in jT.make_caches(
        jcfg, b, 100, jnp.float32, long_context=lc)] for lc in (False, True)}
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, audio=audio, toks=toks,
                prompt=prompt, steps=steps, enc=np.asarray(enc),
                logits=np.asarray(logits), loss=float(loss), grad=_jtree(g),
                cache_len=cache_len, want=[np.asarray(o) for o in outs],
                greedy=np.concatenate(greedy, axis=1), rings=rings,
                pparams=lm_params_from_numpy(_jtree(params), pcfg, "cpu"))


def test_init_layout_matches_reference(ref):
    pcfg = ref["pcfg"]
    mine = T.init_params(torch.Generator().manual_seed(0), pcfg,
                         device="cpu")
    got = jax.tree_util.tree_structure(tree_to_numpy(mine))
    want = jax.tree_util.tree_structure(ref["grad"])
    assert got == want
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(mine)),
                    jax.tree_util.tree_leaves(ref["grad"])):
        assert a.shape == b.shape


def test_encode_decode_and_loss_match_reference(ref):
    pcfg, pp = ref["pcfg"], ref["pparams"]
    prompt = ref["prompt"]
    audio = torch.from_numpy(ref["audio"])
    toks = torch.from_numpy(ref["toks"][:, :prompt]).long()
    enc = encdec.encode(pp, pcfg, audio)
    _close(enc, ref["enc"])
    _close(encdec.encode(pp, pcfg, audio, flash=True), ref["enc"])
    _close(encdec.decode(pp, pcfg, toks, enc), ref["logits"])
    batch = {"audio_embeds": audio, "tokens": toks}
    loss, metrics = T.loss_fn(pp, pcfg, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=RTOL)
    assert float(metrics["aux"]) == 0.0 and metrics["loss"] is loss
    g = grad(lambda p: T.loss_fn(p, pcfg, batch)[0])(pp)
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(g)),
                    jax.tree_util.tree_leaves(ref["grad"])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=GATOL)
    with pytest.raises(KeyError, match="audio_embeds"):
        T.loss_fn(pp, pcfg, {"tokens": toks})


def _serve(ref, cache_len, long_context=False):
    """The port's prefill and 4 decode steps on the reference's greedy
    tokens; returns (per-step logits, caches, the flash op's calls)."""
    pcfg, pp, prompt, greedy = ref["pcfg"], ref["pparams"], ref["prompt"], \
        ref["greedy"]
    caches = T.make_caches(pcfg, greedy.shape[0], cache_len, torch.float32,
                           long_context=long_context, device="cpu")
    batch = {"audio_embeds": torch.from_numpy(ref["audio"]),
             "tokens": torch.from_numpy(ref["toks"][:, :prompt]).long()}
    calls = []
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **k: calls.append(k) or real(*a, **k)
    try:
        got, caches = T.prefill(pp, pcfg, batch, caches,
                                long_context=long_context)
        outs = [got]
        for i in range(ref["steps"]):
            got, caches = T.decode_step(
                pp, pcfg, torch.from_numpy(greedy[:, i:i + 1]).long(),
                caches, prompt + i, long_context=long_context)
            outs.append(got)
    finally:
        ops.flash_attention = real
    return outs, caches, calls


def test_prefill_and_decode_match_reference(ref):
    """Prefill + 4 decode steps on the reference's greedy tokens; each
    prefill is enc_layers + 2·n_layers flash calls (the encoder's and the
    cross-attention non-causal) and each step 2·n_layers."""
    pcfg = ref["pcfg"]
    outs, caches, calls = _serve(ref, ref["cache_len"])
    for g, w in zip(outs, ref["want"]):
        _close(g, w)
    assert caches[0]["cross_k"].shape == (2, pcfg.encoder.n_ctx,
                                          pcfg.attn.n_kv_heads,
                                          pcfg.attn.head_dim)
    n_prefill = pcfg.encoder.n_layers + 2 * pcfg.n_layers
    assert len(calls) == n_prefill + ref["steps"] * 2 * pcfg.n_layers
    assert [c["causal"] for c in calls[:n_prefill]] == \
        [False] * pcfg.encoder.n_layers + [True, False] * pcfg.n_layers


def test_long_context_only_bounds_the_rings(ref):
    """Under ``long_context`` the audio family's rings are min(cache_len,
    long_context_window) long, as the reference's, and its prefill and
    decode steps run unwindowed (the reference does not pass the flag
    on): inside the ring the logits equal the unbounded run's."""
    outs, caches, _ = _serve(ref, 100, long_context=True)
    assert [c["self"].pos.shape[1] for c in caches] == ref["rings"][True]
    assert ref["rings"] == {False: [100, 100], True: [64, 64]}
    for g, w in zip(outs, ref["want"]):
        _close(g, w)


def test_generate_matches_reference_greedy_decode(ref):
    """`launch.serve.generate` with the batch's audio: the reference's
    greedy tokens and per-step logits."""
    pcfg, pp, prompt = ref["pcfg"], ref["pparams"], ref["prompt"]
    res = serve.generate(pp, pcfg,
                         torch.from_numpy(ref["toks"][:, :prompt]).long(),
                         ref["steps"] + 1, ref["cache_len"],
                         extra={"audio_embeds": torch.from_numpy(
                             ref["audio"])}, return_logits=True)
    np.testing.assert_array_equal(res.tokens[:, :-1].numpy(), ref["greedy"])
    for g, w in zip(res.logits, ref["want"]):
        _close(g, w[:, -1])


def test_serve_smoke_cli_runs_whisper(capsys):
    """The smoke CLI draws whisper's audio embeds from a generator of
    their own, as the reference draws them from their own key."""
    got = serve.main(["--arch", ARCH, "--device", "cpu", "--tokens", "3",
                      "--batch", "2", "--prompt-len", "8"])
    assert got.shape == (2, 3)
    assert "prefill 8 tokens x2" in capsys.readouterr().out


def test_training_clis_refuse_whisper_as_the_reference():
    """The LM loss of `launch.train` hands the model a token batch; the
    reference's whisper loss then raises `KeyError` (its
    ``audio_embeds``), and so does the port's, before any training."""
    with pytest.raises(KeyError):
        jtrain._lm_fns(ARCH, "cpu-small")[1](
            jtrain.init_model_params(jax.random.PRNGKey(0),
                                     jtrain.preset_config(ARCH, "cpu-small")),
            {"x": jnp.zeros((2, 8), jnp.int32)})
    with pytest.raises(KeyError, match="audio_embeds"):
        train.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                    "--clients", "2", "--pool", "5", "--seq", "8",
                    "--batch", "2", "--placement", "host"])
    with pytest.raises(KeyError, match="audio_embeds"):
        serve.main(["--federated", "--device", "cpu", "--arch", ARCH,
                    "--rounds", "1", "--clients", "2", "--pool", "5",
                    "--requests", "1", "--tokens", "2", "--prompt-len", "8"])


def test_smoke_config_and_registry():
    jcfg, pcfg = jget_smoke_config(ARCH), configs.get_smoke_config(ARCH)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.family == "audio" and pcfg.pos_embedding == "learned"
