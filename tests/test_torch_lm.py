"""The port's dense-decoder serving path against the reference, on the CPU.

Layers, attention with its ring caches, the transformer's prefill and
decode, the params converter and `launch.serve.generate`, each against
the reference (`repro.models`, `repro.launch.serve`) on the same numpy
inputs and params.  The port runs with ``device="cpu"``, where attention
goes through the flash op's plain version.  Model-level tolerance is
rtol = atol = 2e-4, that of tests/test_models.py's decode checks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.launch import serve as jserve
from repro.launch.steps import init_model_params
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import scan as jscan
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import (lm_params_from_numpy, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.launch import serve
from repro_torch.models import attention, layers
from repro_torch.models import transformer as T

KEY = jax.random.PRNGKey(0)
TOL = 2e-4
DENSE = ("gemma2-27b", "gemma-2b", "stablelm-3b")


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _jax_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        got = (configs.get_smoke_config(arch) if smoke
               else configs.get_config(arch))
        want = jget_smoke_config(arch) if smoke else jget_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.pdtype == getattr(torch, want.param_dtype)
        assert [got.attn_window(i) for i in range(4)] == \
            [want.attn_window(i) for i in range(4)]


def test_registry_refuses_other_families():
    for arch in ("whisper-tiny", "paligemma-3b"):
        with pytest.raises(NotImplementedError, match="item 16b"):
            configs.get_config(arch)
    assert sorted(configs.registry.NOT_PORTED) == ["paligemma-3b",
                                                   "whisper-tiny"]
    with pytest.raises(KeyError):
        configs.get_config("nope")
    # deepseek-v3 (MLA), the SSM and hybrid families and nemotron are
    # ported: their configs are the reference's
    for arch in ("deepseek-v3-671b", "mamba2-780m", "zamba2-2.7b",
                 "nemotron-4-340b"):
        assert arch not in configs.registry.NOT_PORTED
        for got, want in ((configs.get_config(arch), jget_config(arch)),
                          (configs.get_smoke_config(arch),
                           jget_smoke_config(arch))):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# layers


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    xt = torch.from_numpy(x)
    for kind in ("rmsnorm", "layernorm"):
        p = {"scale": rng.standard_normal(48).astype(np.float32) * 0.1,
             "bias": rng.standard_normal(48).astype(np.float32) * 0.1}
        if kind == "rmsnorm":
            del p["bias"]
        _close(layers.norm_apply(kind, tree_from_numpy(p, "cpu"), xt,
                                 torch.float32),
               jlayers.norm_apply(kind, p, jnp.asarray(x), jnp.float32),
               1e-5)
    h = rng.standard_normal((2, 5, 3, 80)).astype(np.float32)
    pos = np.arange(7, 12)
    for frac in (1.0, 0.25):
        _close(layers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                                 10000.0, frac),
               jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos)[None],
                                  10000.0, frac), 1e-5)
    for act, gated in (("geglu", True), ("silu", True), ("relu2", False)):
        mp = jlayers.mlp_init(KEY, 48, 96, gated, jnp.float32)
        _close(layers.mlp_apply(tree_from_numpy(_jax_tree(mp), "cpu"), xt,
                                act, torch.float32),
               jlayers.mlp_apply(mp, jnp.asarray(x), act, jnp.float32), 1e-5)
    w = rng.standard_normal((48, 3, 16)).astype(np.float32)
    _close(layers.dense_apply(torch.from_numpy(w), xt, torch.float32),
           jlayers.dense_apply(jnp.asarray(w), jnp.asarray(x), jnp.float32),
           1e-5)
    _close(layers.softcap(xt * 40, 30.0),
           jlayers.softcap(jnp.asarray(x) * 40, 30.0), 1e-5)
    assert layers.softcap(xt, None) is xt
    table = rng.standard_normal((11, 48)).astype(np.float32)
    tok = np.array([[3, 0, 10]])
    _close(layers.embedding_lookup(torch.from_numpy(table),
                                   torch.from_numpy(tok), torch.float32),
           jlayers.embedding_lookup(jnp.asarray(table), jnp.asarray(tok),
                                    jnp.float32), 0)


# ---------------------------------------------------------------------------
# attention with ring caches: every routing case of models/attention.py


def _attn_cfg():
    """gemma2 smoke, widened to GQA group 2 at head_dim 128, window 16."""
    cfg = jget_smoke_config("gemma2-27b")
    a = dataclasses.replace(cfg.attn, n_heads=4, n_kv_heads=2, head_dim=128,
                            window=16)
    cfg = dataclasses.replace(cfg, attn=a)
    pcfg = configs.get_smoke_config("gemma2-27b")
    pcfg = dataclasses.replace(pcfg, attn=dataclasses.replace(
        pcfg.attn, n_heads=4, n_kv_heads=2, head_dim=128, window=16))
    return cfg, pcfg


# (cache_len, window, prompt, decode steps): S <= C, S > C, decode before
# and after the ring wraps, and a ring longer than its window
RINGS = [(40, None, 24, 6), (16, 16, 12, 8), (16, 16, 24, 6),
         (28, None, 24, 8), (20, 16, 12, 12)]


@pytest.mark.parametrize("cache_len,window,prompt,steps", RINGS)
def test_attention_with_cache_matches_reference(cache_len, window, prompt,
                                                steps):
    jcfg, pcfg = _attn_cfg()
    params = jattn.attn_init(KEY, jcfg)
    pparams = tree_from_numpy(_jax_tree(params), "cpu")
    b = 2
    x = np.random.default_rng(prompt).standard_normal(
        (b, prompt + steps, jcfg.d_model)).astype(np.float32)
    jc = jattn.init_cache(jcfg, b, cache_len, jnp.float32)
    pc = attention.init_cache(pcfg, b, cache_len, torch.float32, "cpu")
    spans = [(0, prompt)] + [(prompt + i, prompt + i + 1)
                             for i in range(steps)]
    jitted = jax.jit(lambda p, x, pos, c: jattn.attention(
        p, jcfg, x, pos, cache=c, window=window))
    for lo, hi in spans:
        pos = jnp.broadcast_to(jnp.arange(lo, hi, dtype=jnp.int32),
                               (b, hi - lo))
        want, jc = jitted(params, jnp.asarray(x[:, lo:hi]), pos, jc)
        got, pc = attention.attention(pparams, pcfg,
                                      torch.from_numpy(x[:, lo:hi]), lo,
                                      cache=pc, window=window)
        _close(got, want)
        for g, w in zip(pc, jc):
            _close(g, w, 1e-5)          # k after RoPE, v, pos


def test_attention_refuses_what_this_slice_lacks():
    _, pcfg = _attn_cfg()
    gen = torch.Generator().manual_seed(0)
    p = attention.attn_init(gen, pcfg, device="cpu")
    x = torch.zeros((1, 3, pcfg.d_model))
    with pytest.raises(NotImplementedError, match="item 16b"):
        attention.attention(p, pcfg, x, 0, kv_input=x)
    with pytest.raises(NotImplementedError, match="item 16b"):
        attention.attention(p, pcfg, x, 0, prefix_len=2)
    mla = dataclasses.replace(pcfg, attn=dataclasses.replace(
        pcfg.attn, mla=configs.base.MLAConfig(
            q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=8, v_head_dim=8)))
    c = attention.init_cache(pcfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="wrap"):
        attention.attention(p, pcfg, x, 6, cache=c)
    # MLA, the deepseek-v3 config's attention, inits, makes its latent
    # rings and runs (tests/test_torch_mla.py holds it to the reference);
    # sequence-parallel decode still raises
    mla_moe = dataclasses.replace(configs.get_smoke_config("olmoe-1b-7b"),
                                  attn=mla.attn)
    params = T.init_params(gen, mla_moe, device="cpu")
    assert "wkv_b" in params["layers"][0]["attn"]
    caches = T.make_caches(mla_moe, 1, 8, torch.float32, device="cpu")
    assert caches[0].k.shape == (1, 8, 16) and caches[0].v.shape == (1, 8, 8)
    logits, _ = T.prefill(params, mla_moe,
                          {"tokens": torch.zeros((1, 3), dtype=torch.long)},
                          caches)
    assert logits.shape == (1, 1, mla_moe.vocab_size)
    assert bool(torch.isfinite(logits).all())
    sp = dataclasses.replace(mla_moe, attn=dataclasses.replace(
        mla.attn, seq_parallel=True))
    for fn in (lambda c: T.init_params(gen, c, device="cpu"),
               lambda c: T.make_caches(c, 1, 8, torch.float32,
                                       device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="sequence-parallel.*item 16b"):
            fn(sp)


# ---------------------------------------------------------------------------
# the stack: forward, prefill and decode


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    jcfg = jget_smoke_config(arch)
    pcfg = configs.get_smoke_config(arch)
    params = jT.init_params(KEY, jcfg)
    pparams = lm_params_from_numpy(_jax_tree(params), pcfg, "cpu")
    b, prompt, cache_len, steps = 2, 80, 96, 6   # gemma2's local ring wraps
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (b, prompt + steps)).astype(np.int32)
    fwd, _ = jax.jit(lambda p, t: jT.forward(p, jcfg, {"tokens": t}))(
        params, jnp.asarray(toks[:, :40]))
    pfwd, _ = T.forward(pparams, pcfg,
                        {"tokens": torch.from_numpy(toks[:, :40]).long()})
    _close(pfwd, fwd)
    jc = jT.make_caches(jcfg, b, cache_len, jnp.float32)
    pc = T.make_caches(pcfg, b, cache_len, torch.float32, device="cpu")
    assert [c.pos.shape[1] for c in pc] == [c.pos.shape[1] for c in jc]
    want, jc = jax.jit(lambda p, t, c: jT.prefill(p, jcfg, {"tokens": t}, c))(
        params, jnp.asarray(toks[:, :prompt]), jc)
    got, pc = T.prefill(pparams, pcfg, {"tokens": torch.from_numpy(
        toks[:, :prompt]).long()}, pc)
    _close(got, want)
    decode = jax.jit(lambda p, t, c, pos: jT.decode_step(p, jcfg, t, c, pos))
    for i in range(steps):
        p = prompt + i
        tok = toks[:, p:p + 1]
        want, jc = decode(params, jnp.asarray(tok), jc,
                          jnp.full((b,), p, jnp.int32))
        pos = torch.full((b,), p) if i % 2 else p   # a tensor or an int
        got, pc = T.decode_step(pparams, pcfg, torch.from_numpy(tok).long(),
                                pc, pos)
        _close(got, want)


def test_decode_refuses_ragged_positions():
    pcfg = configs.get_smoke_config("gemma2-27b")
    params = T.init_params(torch.Generator().manual_seed(0), pcfg,
                           device="cpu")
    caches = T.make_caches(pcfg, 2, 16, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="lockstep"):
        T.decode_step(params, pcfg, torch.zeros((2, 1), dtype=torch.long),
                      caches, torch.tensor([3, 4]))


def test_windowed_ring_prefill_matches_full_cache():
    """Counterpart of tests/test_models.py's: a prefill longer than the
    local ring, then 3 decode steps, against full-length caches."""
    cfg = configs.get_smoke_config("gemma2-27b")
    assert cfg.attn_window(0) == 64 and cfg.attn_window(1) is None
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    b, s = 2, 96
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(1))
    caches = T.make_caches(cfg, b, s + 4, torch.float32, device="cpu")
    assert caches[0].pos.shape[1] == 64
    oracle = [attention.init_cache(cfg, b, s + 4, torch.float32, "cpu")
              for _ in range(cfg.n_layers)]
    logits, caches = T.prefill(params, cfg, {"tokens": toks}, caches)
    logits_f, oracle = T.prefill(params, cfg, {"tokens": toks}, oracle)
    _close(logits, logits_f)
    tok = toks[:, -1:]
    for step in range(3):
        a, caches = T.decode_step(params, cfg, tok, caches, s + step)
        f, oracle = T.decode_step(params, cfg, tok, oracle, s + step)
        _close(a, f)


# ---------------------------------------------------------------------------
# params from the reference


def test_lm_params_from_numpy_both_layouts_and_bf16():
    jcfg = jget_smoke_config("gemma2-27b")
    pcfg = configs.get_smoke_config("gemma2-27b")
    loop = jT.init_params(KEY, jcfg)
    scanned = jscan.stack_layer_params(loop, jcfg)
    assert isinstance(scanned["scan_layers"], tuple)
    a = lm_params_from_numpy(_jax_tree(loop), pcfg, "cpu")
    b = lm_params_from_numpy(_jax_tree(scanned), pcfg, "cpu")
    assert len(a["layers"]) == len(b["layers"]) == pcfg.n_layers
    flat_a = jax.tree_util.tree_leaves(tree_to_numpy(a))
    flat_b = jax.tree_util.tree_leaves(tree_to_numpy(b))
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        a["layers"][1]["attn"]["wq"].numpy(),
        np.asarray(loop["layers"][1]["attn"]["wq"]))
    # bf16 leaves (ml_dtypes.bfloat16 in numpy) keep their bits
    bf = jax.tree_util.tree_map(lambda l: np.asarray(l.astype(jnp.bfloat16)),
                                scanned)
    c = lm_params_from_numpy(bf, pcfg, "cpu")
    w = c["layers"][1]["mlp"]["up"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(loop["layers"][1]["mlp"]["up"].astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_tree_from_numpy_walks_lists_tuples_and_bf16():
    leaf = np.asarray(jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16))
    assert leaf.dtype.name == "bfloat16"
    tree = {"a": [np.arange(3), (np.ones(2, np.float32), leaf)], "n": None}
    out = tree_from_numpy(tree, "cpu")
    assert isinstance(out["a"], list) and isinstance(out["a"][1], tuple)
    assert out["n"] is None and out["a"][0].tolist() == [0, 1, 2]
    assert out["a"][1][1].dtype == torch.bfloat16
    assert out["a"][1][1].float().tolist() == [1.5, -2.25, 3.0]
    back = tree_to_numpy({"a": [out["a"][0]]})
    np.testing.assert_array_equal(back["a"][0], np.arange(3))


# ---------------------------------------------------------------------------
# the serving entry point against the reference's smoke_main


def test_generate_matches_reference_smoke_main():
    """Seed 0 and the reference CLI's defaults (batch 4, prompt 32, 16
    tokens, cache 128): the same scan-layout params and prompt through
    `generate`, per-step logits within 2e-4 and equal tokens."""
    arch, b, plen, n, clen = "gemma2-27b", 4, 32, 16, 128
    want_tokens = jserve.main(["--arch", arch])
    jcfg = jget_smoke_config(arch)
    kparams, ktok, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    params = init_model_params(kparams, jcfg)
    prompt = jax.random.randint(ktok, (b, plen), 0, jcfg.vocab_size)
    caches = jscan.stack_caches(jT.make_caches(jcfg, b, clen, jnp.float32),
                                jcfg)
    logits, caches = jax.jit(lambda p, t, c: jscan.prefill(
        p, jcfg, {"tokens": t}, c))(params, prompt, caches)
    decode = jax.jit(lambda p, t, c, pos: jscan.decode_step(p, jcfg, t, c,
                                                           pos))
    want_logits, toks = [logits[:, -1]], []
    for i in range(n - 1):
        tok = jnp.argmax(want_logits[-1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
        logits, caches = decode(params, tok, caches,
                                jnp.full((b,), plen + i, jnp.int32))
        want_logits.append(logits[:, -1])
    toks.append(jnp.argmax(want_logits[-1], axis=-1)[:, None])
    np.testing.assert_array_equal(np.concatenate(toks, 1), want_tokens)

    pcfg = configs.get_smoke_config(arch)
    pparams = lm_params_from_numpy(_jax_tree(params), pcfg, "cpu")
    res = serve.generate(pparams, pcfg,
                         torch.tensor(np.asarray(prompt)).long(), n,
                         clen, return_logits=True)
    assert res.tokens.shape == (b, n) and len(res.logits) == n
    for g, w in zip(res.logits, want_logits):
        _close(g, w)
    np.testing.assert_array_equal(res.tokens.numpy(), want_tokens)


def test_serve_cli_runs_on_the_cpu(capsys):
    toks = serve.main(["--arch", "stablelm-3b", "--device", "cpu",
                       "--tokens", "4"])
    assert toks.shape == (4, 4)
    out = capsys.readouterr().out
    assert "prefill 32 tokens x4" in out and "tok/s" in out
