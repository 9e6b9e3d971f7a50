"""The port's MLA (deepseek-v3-671b) against the reference, on the CPU.

`attention._mla_attention` on its two paths (naive: the latent expanded
and attended by the flash op, whose plain version takes the value head
dim 16 apart from the query/key head dim 24; absorbed: plain einsums in
the latent space), with no cache and with a latent ring (a prefill, then
decode steps; a ring that wraps and a prefill longer than the ring);
`transformer.prefill` / `decode_step` logits; `loss_fn` and its
gradients against `jax.grad` in the loop and the scan form; the configs
and presets; `launch.serve`'s smoke decode and `launch.train`'s CLI; and
the two ``--federated --store`` CLIs on one reference store file, all on
the same numpy params, inputs and tokens.  The configs are the
reference's own, cut by `reduced` as tests/test_torch_moe.py cuts
olmoe: 2 layers, the first dense (d_ff 256), 4 experts top 2 plus one
shared, MLA q_lora 64, kv_lora 32, nope 16, rope 8, v 16 (dk 24, dv 16),
f32.  Tolerances: the layer and its latent ring at rtol = atol = 1e-5;
model logits at 2e-4 as tests/test_torch_lm.py; losses and gradients at
rtol 1e-4, atol 1e-6 as tests/test_torch_lm_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import reduced as jreduced
from repro.fl.serve import DeltaStore as JDeltaStore
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import scan as jscan
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import (lm_params_from_numpy, lm_view_from_numpy,
                                 lm_view_to_numpy, tree_from_numpy)
from repro_torch.launch import serve, train
from repro_torch.models import attention, scan
from repro_torch.models import transformer as T

ARCH = "deepseek-v3-671b"
TINY = dict(n_layers=2, d_model=64, vocab=128, max_seq=64)
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


def _jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(absorb: bool = False):
    """The reference's and the port's deepseek at TINY widths; ``absorb``
    takes the absorbed MLA path."""
    jcfg = jreduced(jget_config(ARCH), **TINY)
    pcfg = configs.reduced(configs.get_config(ARCH), **TINY)
    if absorb:
        fix = lambda c: dataclasses.replace(  # noqa: E731
            c, attn=dataclasses.replace(c.attn, mla_absorb=True))
        jcfg, pcfg = fix(jcfg), fix(pcfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    return jcfg, pcfg


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the registry, the configs and the presets


def test_configs_and_presets_match_reference():
    for smoke in (False, True):
        got = (configs.get_smoke_config(ARCH) if smoke
               else configs.get_config(ARCH))
        want = jget_smoke_config(ARCH) if smoke else jget_config(ARCH)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ARCH in configs.ARCH_IDS
    m = configs.get_config(ARCH).attn.mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == \
        (192, 128)
    for preset in ("cpu-small", "lm-100m", "full"):
        assert dataclasses.asdict(train.preset_config(ARCH, preset)) == \
            dataclasses.asdict(jtrain.preset_config(ARCH, preset))


# ---------------------------------------------------------------------------
# the MLA layer


# (cache length, prompt, decode steps): None is the no-cache path; a
# linear ring; a ring that wraps on the decode steps; a prefill longer
# than the ring (the in-flight keys)
LAYER_CASES = [(None, 20, 0), (32, 20, 4), (16, 12, 6), (16, 20, 3)]


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("cache_len,prompt,steps", LAYER_CASES)
def test_mla_attention_matches_reference(absorb, cache_len, prompt, steps):
    jcfg, pcfg = _cfgs(absorb)
    params = jattn.attn_init(jax.random.PRNGKey(0), jcfg)
    pparams = tree_from_numpy(_jtree(params), "cpu")
    assert sorted(pparams) == ["kv_norm", "q_norm", "wkv_a", "wkv_b", "wo",
                               "wq_a", "wq_b"]
    b = 2
    x = np.random.default_rng(prompt).standard_normal(
        (b, prompt + steps, jcfg.d_model)).astype(np.float32)
    spans = [(0, prompt)] + [(prompt + i, prompt + i + 1)
                             for i in range(steps)]
    jc = pc = None
    if cache_len is not None:
        jc = jattn.init_cache(jcfg, b, cache_len, jnp.float32)
        pc = attention.init_cache(pcfg, b, cache_len, torch.float32, "cpu")
        m = pcfg.attn.mla
        assert pc.k.shape == (b, cache_len, m.kv_lora_rank)
        assert pc.v.shape == (b, cache_len, m.qk_rope_head_dim)
    jitted = jax.jit(lambda p, x, pos, c: jattn.attention(p, jcfg, x, pos,
                                                          cache=c))
    for lo, hi in spans:
        pos = jnp.broadcast_to(jnp.arange(lo, hi, dtype=jnp.int32),
                               (b, hi - lo))
        want, jc = jitted(params, jnp.asarray(x[:, lo:hi]), pos, jc)
        got, pc = attention.attention(pparams, pcfg,
                                      torch.from_numpy(x[:, lo:hi]), lo,
                                      cache=pc)
        np.testing.assert_allclose(_np(got), _np(want), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)
        if cache_len is None:
            assert pc is None and jc is None
            continue
        for g, w in zip(pc, jc):       # c_kv, k_rope (after RoPE), pos
            np.testing.assert_allclose(_np(g), _np(w), rtol=LAYER_TOL,
                                       atol=LAYER_TOL)


def test_mla_refuses_sequence_parallel_decode():
    """Sequence-parallel decode runs on MLA: on one card it computes what
    the flag off computes (`models/attention.py`), on both paths, a
    prefill and decode steps over a latent ring, bitwise."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 9, TINY["d_model"])
                                             ).astype(np.float32))
    for absorb in (False, True):
        _, pcfg = _cfgs(absorb)
        p = attention.attn_init(torch.Generator().manual_seed(1), pcfg,
                                device="cpu")
        outs = []
        for sp in (False, True):
            cfg = dataclasses.replace(pcfg, attn=dataclasses.replace(
                pcfg.attn, seq_parallel=sp))
            c = attention.init_cache(cfg, 2, 12, torch.float32, "cpu")
            got = [attention.attention(p, cfg, x[:, :6], 0, cache=c)[0]]
            for i in range(6, 9):
                got.append(attention.attention(p, cfg, x[:, i:i + 1], i,
                                               cache=c)[0])
            outs.append(got + [c.k, c.v])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the stack


@pytest.mark.parametrize("absorb", [False, True])
def test_prefill_and_decode_match_reference(absorb):
    jcfg, pcfg = _cfgs(absorb)
    params = jT.init_params(jax.random.PRNGKey(3), jcfg)
    assert "mlp" in params["layers"][0] and "moe" in params["layers"][1]
    pparams = lm_params_from_numpy(_jtree(params), pcfg, "cpu")
    b, prompt, cache_len, steps = 2, 40, 48, 5
    toks = _tokens(jcfg, b, prompt + steps, seed=1)
    jc = jT.make_caches(jcfg, b, cache_len, jnp.float32)
    want, jc = jax.jit(lambda p, t, c: jT.prefill(p, jcfg, {"tokens": t}, c))(
        params, jnp.asarray(toks[:, :prompt]), jc)
    pc = T.make_caches(pcfg, b, cache_len, torch.float32, device="cpu")
    got, pc = T.prefill(pparams, pcfg, {"tokens": torch.from_numpy(
        toks[:, :prompt]).long()}, pc)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    decode = jax.jit(lambda p, t, c, pos: jT.decode_step(p, jcfg, t, c, pos))
    for i in range(steps):
        p = prompt + i
        tok = toks[:, p:p + 1]
        want, jc = decode(params, jnp.asarray(tok), jc,
                          jnp.full((b,), p, jnp.int32))
        got, pc = T.decode_step(pparams, pcfg, torch.from_numpy(tok).long(),
                                pc, p)
        np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    for g, w in zip(pc[0], jc[0]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL, atol=TOL)


def test_losses_and_gradients_match_jax_grad():
    """The loop form and the scanned layout (the dense-first layer its
    prefix) with its flat-key view, against `jax.grad`."""
    jcfg, pcfg = _cfgs()
    toks = jnp.asarray(_tokens(jcfg, 2, 24))
    batch = {"tokens": torch.from_numpy(np.array(toks)).long()}
    loop = jT.init_params(jax.random.PRNGKey(0), jcfg)
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, jcfg, {"tokens": toks}), has_aux=True))(loop)
    ploop = lm_params_from_numpy(_jtree(loop), pcfg, "cpu")
    pg, pm = grad(lambda p: T.loss_fn(p, pcfg, batch), has_aux=True)(ploop)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=RTOL)
    for i, (a, b) in enumerate(zip(pg["layers"], jg["layers"])):
        flat = scan.flat_params(a)
        assert any(k.startswith("attn.wkv_b") for k in flat)
        for k, v in scan.flat_params(_jtree(b)).items():
            np.testing.assert_allclose(_np(flat[k]), v, rtol=RTOL,
                                       atol=GATOL, err_msg=f"layer {i} {k}")

    scanned = jscan.stack_layer_params(loop, jcfg)
    assert scan.layer_grouping(pcfg) == jscan.layer_grouping(jcfg)
    (sl, _), sg = jax.jit(jax.value_and_grad(
        lambda p: jscan.loss_fn(p, jcfg, {"tokens": toks}), has_aux=True))(
        scanned)
    view = lm_view_from_numpy(_jtree(scanned), "cpu")
    loss_fn, _ = train.lm_fns(pcfg)
    vg, vl = grad(loss_fn, has_aux=True)(view, {"x": batch["tokens"]})
    np.testing.assert_allclose(float(vl["loss"]), float(sl), rtol=RTOL)
    for k, v in scan.flat_params(_jtree(sg)).items():
        np.testing.assert_allclose(_np(vg[k]), v, rtol=RTOL, atol=GATOL,
                                   err_msg=k)
    back = lm_view_to_numpy(view, pcfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_jtree(scanned))
    # the port's own stack/unstack round trip keeps every MLA leaf
    restacked = scan.stack_layer_params(ploop, pcfg)
    assert scan.flat_params(scan.unstack_layer_params(restacked, pcfg)) \
        .keys() == scan.flat_params(ploop).keys()


# ---------------------------------------------------------------------------
# the CLIs


def test_smoke_serve_and_train_cli_run_deepseek(capsys):
    """`launch.serve`'s smoke decode and `launch.train`'s CLI at
    cpu-small take ``--arch deepseek-v3-671b`` (the "pod" client axis:
    no momentum)."""
    toks = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--tokens", "3"])
    assert toks.shape == (2, 3)
    loss = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                       "--clients", "2", "--pool", "5", "--seq", "8",
                       "--batch", "2", "--placement", "host",
                       "--algorithm", "fedavg"])
    assert np.isfinite(loss)
    assert f"arch={ARCH}" in capsys.readouterr().out


def test_federated_cli_matches_reference_cli(tmp_path, capsys):
    """``--federated --store``: the reference's CLI and the port's serve one
    store file (the reference's, at the cpu-small preset) with the
    reference's per-user prompts, and print the same served tokens.  The
    port's per-user decode runs the flash op's vmap rule with dv != dk."""
    jcfg = jtrain.preset_config(ARCH, "cpu-small")
    params = jsteps.init_model_params(jax.random.PRNGKey(4), jcfg)
    rng = np.random.default_rng(6)
    stacked = jax.tree_util.tree_map(
        lambda l: (np.asarray(l)[None] + 0.02 * rng.standard_normal(
            (3,) + l.shape)).astype(np.float32), params)
    path = str(tmp_path / "store.msgpack")
    JDeltaStore.build(stacked, assignment=[0, 0, 1]).save(path)
    argv = ["--federated", "--arch", ARCH, "--store", path, "--requests",
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
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    lines = lambda t: [ln for ln in t.splitlines()  # noqa: E731
                       if ln.startswith(("loaded store", "user "))]
    assert lines(got_text) == lines(want_text)
    assert "parity anchor OK" in got_text
