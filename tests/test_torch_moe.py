"""The port's MoE family (olmoe-1b-7b) against the reference, on the CPU.

`moe.moe_apply` (the GShard capacity dispatch: a padded token group whose
zero rows route with tied probabilities, tokens dropped by capacity, a
shared expert), `transformer.loss_fn` and `scan.loss_fn` with their
gradients against `jax.grad`, prefill and decode logits, the layouts
and carriers with MoE leaves, `launch.serve`'s smoke decode and
`launch.train`'s CLI on the family, and a 1-round federated run on
olmoe's tiny config against the reference's, all on the same numpy
params, tokens and draws.  The configs are the reference's own, cut by
`reduced` (1 layer, d_model 64, vocab 128: 4 experts, top 2, groups of
64) and `dataclasses.replace` (a shared expert and a dense-first layer).
Tolerances: the MoE layer at rtol = atol = 1e-5 (f32 einsums summed in
another order); model logits at 2e-4 as tests/test_torch_lm.py; losses
and gradients at rtol 1e-4, atol 1e-6 as tests/test_torch_lm_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import reduced as jreduced
from repro.fl import FLConfig as JFLConfig
from repro.fl import run_federated as j_run
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import moe as jmoe
from repro.models import scan as jscan
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import (fed_from_numpy, lm_params_from_numpy,
                                 lm_view_from_numpy, lm_view_to_numpy,
                                 tree_from_numpy)
from repro_torch.fl import FLConfig, SYSTEMS, run_federated
from repro_torch.launch import serve, train
from repro_torch.models import moe, scan
from repro_torch.models import transformer as T
from test_torch_engine import ReplayDraws

ARCH = "olmoe-1b-7b"
TINY = dict(n_layers=1, d_model=64, vocab=128, max_seq=64)
MOE_TOL = 1e-5
TOL = 2e-4
RTOL, GATOL = 1e-4, 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(shared: bool = False):
    """The reference's and the port's olmoe at TINY widths; ``shared``: 2
    layers, the first dense (d_ff 96), one shared expert."""
    jcfg = jreduced(jget_config(ARCH), **TINY)
    pcfg = configs.reduced(configs.get_config(ARCH), **TINY)
    if shared:
        fix = lambda c: dataclasses.replace(  # noqa: E731
            c, n_layers=2, moe=dataclasses.replace(
                c.moe, n_shared_experts=1, n_dense_layers=1, dense_d_ff=96))
        jcfg, pcfg = fix(jcfg), fix(pcfg)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    return jcfg, pcfg


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the registry and the configs


def test_registry_serves_olmoe():
    for smoke in (False, True):
        got = (configs.get_smoke_config(ARCH) if smoke
               else configs.get_config(ARCH))
        want = jget_smoke_config(ARCH) if smoke else jget_config(ARCH)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.family == "moe" and got.is_moe_layer(0)
    assert ARCH in configs.ARCH_IDS
    # the MoE family's other config, deepseek-v3 (MLA), resolves too
    assert configs.get_config("deepseek-v3-671b").family == "moe"
    for arch in (ARCH, "deepseek-v3-671b"):
        for preset in ("cpu-small", "lm-100m", "full"):
            assert dataclasses.asdict(train.preset_config(arch, preset)) == \
                dataclasses.asdict(jtrain.preset_config(arch, preset))


# ---------------------------------------------------------------------------
# the MoE layer


def test_top_k_breaks_ties_as_jax():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                        [0.5, 0.2, 0.2, 0.1], [0.3, 0.3, 0.1, 0.3]],
                       np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    pv, pi = moe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    pos = torch.tensor([0, 2, 3, 7])
    np.testing.assert_array_equal(
        moe._one_hot(pos, 3, torch.float32).numpy(),
        np.asarray(jax.nn.one_hot(jnp.asarray(pos.numpy()), 3)))


def _moe_inputs(kind: str, d: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "padded":
        # 2 x 37 tokens = 74: the second group of 64 holds 54 zero rows,
        # which route with tied (uniform) probabilities
        x = rng.standard_normal((2, 37, d)).astype(np.float32)
        x[1, -3:] = 0.0
        return x
    # one token repeated: every token picks the same two experts, so the
    # buffers (capacity 40 of a group of 64) overflow and drop tokens
    row = rng.standard_normal(d).astype(np.float32)
    x = np.broadcast_to(row, (1, 64, d)).copy()
    x[0, :8] += 0.1 * rng.standard_normal((8, d)).astype(np.float32)
    return x


@pytest.mark.parametrize("kind,shared", [("padded", False),
                                         ("dropped", False),
                                         ("padded", True)])
def test_moe_apply_matches_reference(kind, shared):
    jcfg, pcfg = _cfgs(shared)
    params = _jtree(jmoe.moe_init(jax.random.PRNGKey(1), jcfg))
    pparams = tree_from_numpy(params, "cpu")
    assert ("shared" in pparams) == shared
    x = _moe_inputs(kind, jcfg.d_model)
    y, aux = jax.jit(lambda p, v: jmoe.moe_apply(p, jcfg, v))(
        params, jnp.asarray(x))
    py, paux = moe.moe_apply(pparams, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(py), _np(y), rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(float(paux), float(aux), rtol=MOE_TOL)

    # the dispatch itself, bitwise: same routing, same drops
    m = pcfg.moe
    xt = torch.from_numpy(x.reshape(-1, jcfg.d_model))
    n_tok = xt.shape[0]
    gs = min(m.group_size, n_tok)
    xg = torch.cat([xt, xt.new_zeros(((-n_tok) % gs, xt.shape[1]))]
                   ).reshape(-1, gs, xt.shape[1])
    probs = torch.softmax(xg @ pparams["router"], dim=-1)
    gates, idx = moe._top_k(probs, m.top_k)
    jg, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), m.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    cap = -(-gs * m.top_k * 5 // (4 * m.n_experts))        # factor 1.25
    dsp, comb = moe._dispatch_tensors(gates, idx, m.n_experts, cap,
                                      torch.float32)
    jd, jc = jmoe._dispatch_tensors(jg, ji, m.n_experts, cap, jnp.float32)
    np.testing.assert_array_equal(dsp.numpy(), np.asarray(jd))
    np.testing.assert_allclose(comb.numpy(), np.asarray(jc), rtol=1e-6)
    routed = int(dsp.sum())
    if kind == "dropped":
        assert routed < n_tok * m.top_k          # capacity dropped some
    else:
        # the pad rows' tied choices are experts 0 and 1, as jax's
        assert (idx[-1, -1] == torch.tensor([0, 1])).all()


def test_moe_apply_vmaps_per_user():
    """Under vmap each user's tokens are its own groups: the vmapped layer
    equals per-user calls."""
    _, pcfg = _cfgs()
    params = moe.moe_init(torch.Generator().manual_seed(2), pcfg, "cpu")
    x = torch.from_numpy(_moe_inputs("padded", pcfg.d_model))[:, None]
    y, aux = vmap(lambda v: moe.moe_apply(params, pcfg, v))(x)
    for i in range(x.shape[0]):
        yi, ai = moe.moe_apply(params, pcfg, x[i])
        np.testing.assert_allclose(_np(y[i]), _np(yi), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(aux[i]), float(ai), rtol=1e-6)


# ---------------------------------------------------------------------------
# the stack: losses, gradients, prefill and decode


def test_losses_and_gradients_match_jax_grad():
    """On the 2-layer config: a dense-first layer (the scanned layout's
    prefix), then a MoE layer with a shared expert."""
    jcfg, pcfg = _cfgs(shared=True)
    toks = jnp.asarray(_tokens(jcfg, 2, 40))
    batch = {"tokens": torch.from_numpy(np.array(toks)).long()}
    loop = jT.init_params(jax.random.PRNGKey(0), jcfg)
    assert "mlp" in loop["layers"][0] and "moe" in loop["layers"][1]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, jcfg, {"tokens": toks}), has_aux=True))(loop)
    ploop = lm_params_from_numpy(_jtree(loop), pcfg, "cpu")
    pg, pm = grad(lambda p: T.loss_fn(p, pcfg, batch), has_aux=True)(ploop)
    assert float(jm["aux"]) > 0
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=RTOL)
    for i, (a, b) in enumerate(zip(pg["layers"], jg["layers"])):
        for k, v in scan.flat_params(_jtree(b)).items():
            np.testing.assert_allclose(_np(scan.flat_params(a)[k]), v,
                                       rtol=RTOL, atol=GATOL,
                                       err_msg=f"layer {i} {k}")

    # the scanned layout (a dense-first layer is its prefix) and its
    # flat-key view, the engine's, leaf for leaf the reference's
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


@pytest.mark.parametrize("shared", [False, True])
def test_prefill_and_decode_match_reference(shared):
    jcfg, pcfg = _cfgs(shared)
    params = jT.init_params(jax.random.PRNGKey(3), jcfg)
    pparams = lm_params_from_numpy(_jtree(params), pcfg, "cpu")
    b, prompt, cache_len, steps = 2, 40, 48, 5     # a padded prefill group
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


def test_smoke_serve_and_train_cli_run_olmoe(capsys):
    """`launch.serve`'s smoke decode and `launch.train`'s CLI take
    ``--arch olmoe-1b-7b`` (the aux rides in the trained loss)."""
    toks = serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--tokens", "3"])
    assert toks.shape == (2, 3)
    loss = train.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                       "--clients", "2", "--pool", "5", "--seq", "8",
                       "--batch", "2", "--placement", "host",
                       "--algorithm", "fedavg"])
    assert np.isfinite(loss)
    assert "arch=olmoe-1b-7b" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# one federated round on olmoe's tiny config


def test_federated_round_matches_reference():
    jcfg, pcfg = _cfgs()
    m, seed = 4, 0
    kw = dict(rounds=1, local_steps=1, batch_size=2, eval_every=1,
              sigma_batches=2, momentum=0.9, opt_state_dtype="param")
    jfed = jtrain.lm_federated_data(jax.random.PRNGKey(3), m, pool=4,
                                    n_val=2, seq=12, vocab=jcfg.vocab_size)
    lm_loss = jsteps._loss_fn(jcfg, remat=False)
    kinit = jax.random.split(jax.random.PRNGKey(seed))[1]
    params0 = _jtree(jsteps.init_model_params(kinit, jcfg))
    want = j_run("ucfl_k2", jfed, fl=JFLConfig(**kw),
                 model_init=lambda k: jsteps.init_model_params(k, jcfg),
                 loss_fn=lambda p, b: lm_loss(p, {"tokens": b["x"]}),
                 acc_fn=lambda p, b: -lm_loss(p, {"tokens": b["x"]})[0],
                 system=J_SYSTEMS["wireless_slow"], keep_state=True,
                 superstep=False, seed=seed)
    fed = fed_from_numpy(*(np.asarray(a) for a in jfed), device="cpu")
    loss_fn, acc_fn = train.lm_fns(pcfg)
    got = run_federated(
        "ucfl_k2", fed, fl=FLConfig(**kw),
        model_init=lambda gen: lm_view_from_numpy(params0, "cpu"),
        loss_fn=loss_fn, acc_fn=acc_fn, system=SYSTEMS["wireless_slow"],
        keep_state=True, seed=seed, draws=ReplayDraws(seed, 1),
        device="cpu")
    assert got.rounds == want.rounds and got.time == want.time
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=RTOL)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=RTOL)
    np.testing.assert_array_equal(got.extras.assignment,
                                  want.extras.assignment)
    np.testing.assert_allclose(got.extras.mixing_matrix,
                               want.extras.mixing_matrix, atol=1e-5)
    wflat = scan.flat_params(_jtree(want.final_params))
    assert sorted(wflat) == sorted(got.final_params)
    assert any(".moe." in k for k in wflat)
    for k, v in wflat.items():
        np.testing.assert_allclose(_np(got.final_params[k]), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
