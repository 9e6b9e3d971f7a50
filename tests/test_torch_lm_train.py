"""The port's LM training path against the reference, on the CPU.

`attention._sdpa_chunked` (causal, window, softcap, GQA; chunks padded),
`transformer.chunked_ce` (a padded tail masked), `transformer.loss_fn`
and `scan.loss_fn` with their gradients (`torch.func.grad` against
`jax.grad`), for the three dense families at reduced f32 configs; the
scanned layout and its flat-key view against `tree_leaves`; the params
and the optimizer state carried across and back; and a 2-round
`run_federated` on LM clients against the reference's, through the
engine's own `ReplayDraws`, with the checkpoint file the CLI writes held
byte for byte to the reference's.  Losses and their gradients at rtol
1e-4 (atol 1e-6 on gradients, whose small entries carry f32 rounding);
clocks, streams and comm counts exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.checkpoint import save_train_state as j_save_train_state
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.fl import FLConfig as JFLConfig
from repro.fl import run_federated as j_run
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import scan as jscan
from repro.models import transformer as jT
from repro_torch import configs
from repro_torch.convert import (fed_from_numpy, lm_opt_state_from_numpy,
                                 lm_opt_state_to_numpy, lm_params_from_numpy,
                                 lm_view_from_numpy, lm_view_to_numpy,
                                 tree_from_numpy, tree_to_numpy)
from repro_torch.fl import FLConfig, SYSTEMS, run_federated
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import steps, train
from repro_torch.models import attention, scan
from repro_torch.models import transformer as T
from test_torch_engine import ReplayDraws

KEY = jax.random.PRNGKey(0)
DENSE = ("gemma2-27b", "gemma-2b", "stablelm-3b")
RTOL, GATOL = 1e-4, 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# attention and the chunked CE


@pytest.mark.parametrize("window,cap,kh", [(None, None, 4), (5, 30.0, 2),
                                           (3, None, 1)])
def test_sdpa_chunked_matches_reference(window, cap, kh):
    rng = np.random.default_rng(kh)
    b, s, h, hd = 2, 19, 4, 8
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    for chunk in (8, 1024):     # padded chunks, and one chunk
        want = jattn._sdpa_chunked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            jnp.asarray(pos), kind="causal", window=window, prefix_len=0,
            cap=cap, cdtype=jnp.float32, chunk=chunk)
        tp = torch.from_numpy(pos.copy())
        got = attention._sdpa_chunked(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tp, tp, kind="causal", window=window, prefix_len=0, cap=cap,
            cdtype=torch.float32, chunk=chunk)
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=1e-5)
    bias = attention.mask_bias(tp[:1], tp[:1], window=window)
    np.testing.assert_array_equal(_np(bias), _np(jattn.mask_bias(
        jnp.asarray(pos[:1]), jnp.asarray(pos[:1]), window=window)))


@pytest.mark.parametrize("arch", DENSE)
def test_chunked_ce_matches_reference(arch):
    jcfg = jget_smoke_config(arch)
    pcfg = configs.get_smoke_config(arch)
    params = jT.init_params(KEY, jcfg)
    pparams = lm_params_from_numpy(_jtree(params), pcfg, "cpu")
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    for chunk in (8, 512):
        want = jax.jit(lambda p, h, t: jT.chunked_ce(
            p, jcfg, h, t, chunk=chunk))(params, jnp.asarray(hidden),
                                         jnp.asarray(tgt))
        got = T.chunked_ce(pparams, pcfg, torch.from_numpy(hidden),
                           torch.from_numpy(tgt).long(), chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


# ---------------------------------------------------------------------------
# the losses and their gradients


def _flat_grads(tree):
    """The reference's gradient tree as the flat-key view (numpy)."""
    return scan.flat_params(_jtree(tree))


@pytest.mark.parametrize("arch", DENSE)
def test_losses_and_gradients_match_jax_grad(arch):
    """`transformer.loss_fn` on the loop layout and `scan.loss_fn` on the
    scanned one, values and gradients against the reference's, and the
    two port forms against each other."""
    jcfg = jget_smoke_config(arch)
    pcfg = configs.get_smoke_config(arch)
    toks = jnp.asarray(_tokens(jcfg, 2, 24))
    batch = {"tokens": torch.from_numpy(np.array(toks)).long()}
    loop = jT.init_params(KEY, jcfg)
    scanned = jscan.stack_layer_params(loop, jcfg)

    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jT.loss_fn(p, jcfg, {"tokens": toks}), has_aux=True))(loop)
    ploop = lm_params_from_numpy(_jtree(loop), pcfg, "cpu")
    pg, pm = grad(lambda p: T.loss_fn(p, pcfg, batch), has_aux=True)(ploop)
    np.testing.assert_allclose(float(pm["loss"]), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(pm["ce"]), float(jm["ce"]), rtol=RTOL)
    for i, (a, b) in enumerate(zip(pg["layers"], jg["layers"])):
        for k, v in scan.flat_params(_jtree(b)).items():
            np.testing.assert_allclose(_np(scan.flat_params(a)[k]), v,
                                       rtol=RTOL, atol=GATOL,
                                       err_msg=f"layer {i} {k}")

    (sl, _), sg = jax.jit(jax.value_and_grad(
        lambda p: jscan.loss_fn(p, jcfg, {"tokens": toks}), has_aux=True))(
        scanned)
    pscan = tree_from_numpy(_jtree(scanned), "cpu")
    psg, psm = grad(lambda p: scan.loss_fn(p, pcfg, batch), has_aux=True)(
        pscan)
    np.testing.assert_allclose(float(psm["loss"]), float(sl), rtol=RTOL)
    assert float(psm["loss"]) == float(pm["loss"])
    got = scan.flat_params(psg)
    for k, v in _flat_grads(sg).items():
        np.testing.assert_allclose(_np(got[k]), v, rtol=RTOL, atol=GATOL,
                                   err_msg=k)
    # remat (the reference's jax.checkpoint of the scan body) recomputes
    # each group in the backward: the same loss, bit for bit
    rl, _ = scan.loss_fn(pscan, pcfg, batch, remat=True)
    assert torch.equal(rl, psm["loss"])


def test_loss_vmaps_over_clients():
    """The engine's `vmap(grad(loss))` over a client-stacked flat view: each
    client's gradient is its own unbatched one."""
    pcfg = configs.get_smoke_config("gemma2-27b")
    jcfg = jget_smoke_config("gemma2-27b")
    tree = _jtree(jsteps.init_model_params(KEY, jcfg))
    flat = lm_view_from_numpy(tree, "cpu")
    loss_fn, _ = train.lm_fns(pcfg)
    toks = torch.from_numpy(_tokens(jcfg, 6, 12)).long().reshape(3, 2, 12)
    stacked = {k: v[None].expand((3,) + v.shape).clone()
               for k, v in flat.items()}
    gs, _ = vmap(grad(loss_fn, has_aux=True))(stacked, {"x": toks})
    for i in range(3):
        g1, _ = grad(loss_fn, has_aux=True)(flat, {"x": toks[i]})
        for k in flat:
            np.testing.assert_allclose(_np(gs[k][i]), _np(g1[k]), rtol=RTOL,
                                       atol=GATOL, err_msg=k)


# ---------------------------------------------------------------------------
# the layouts and the carriers


@pytest.mark.parametrize("arch", DENSE)
def test_layouts_and_flat_view_follow_the_reference(arch):
    jcfg = jget_smoke_config(arch)
    pcfg = configs.get_smoke_config(arch)
    assert scan.layer_grouping(pcfg) == jscan.layer_grouping(jcfg)
    loop = _jtree(jT.init_params(KEY, jcfg))
    scanned = _jtree(jsteps.init_model_params(KEY, jcfg))
    # stack / unstack on the port's tensors, leaf for leaf
    got = scan.stack_layer_params(tree_from_numpy(loop, "cpu"), pcfg)
    assert isinstance(got["scan_layers"], tuple)
    assert isinstance(got["prefix_layers"], list)
    flat = scan.flat_params(got)
    leaves = jax.tree_util.tree_leaves(scanned)
    keys = sorted(flat)
    assert len(keys) == len(leaves)
    for k, leaf in zip(keys, leaves):
        np.testing.assert_array_equal(_np(flat[k]), leaf, err_msg=k)
    back = scan.unstack_layer_params(got, pcfg)
    for a, b in zip(jax.tree_util.tree_leaves(loop),
                    jax.tree_util.tree_leaves(tree_to_numpy(back))):
        np.testing.assert_array_equal(a, b)
    # the carrier: the scanned tree to the flat view and back, in the
    # reference's containers
    view = lm_view_from_numpy(scanned, "cpu")
    again = lm_view_to_numpy(view, pcfg)
    assert (jax.tree_util.tree_structure(again)
            == jax.tree_util.tree_structure(scanned))
    for a, b in zip(jax.tree_util.tree_leaves(again), leaves):
        np.testing.assert_array_equal(a, b)
    # the optimizer state across and back
    jopt = _jtree(jsteps.make_optimizer(jcfg).init(
        jsteps.init_model_params(KEY, jcfg)))
    popt = lm_opt_state_from_numpy(jopt, "cpu")
    assert sorted(popt["mu"]) == keys
    out = lm_opt_state_to_numpy(popt, pcfg)
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(jopt)):
        np.testing.assert_array_equal(a, b)
    assert popt["step"].dtype == torch.int32


def test_flat_keys_sort_numeric_indices():
    tree = {"layers": [{"w": torch.zeros(1)} for _ in range(12)],
            "a": (torch.zeros(1),), "b": []}
    flat = scan.flat_params(tree)
    assert sorted(flat)[:3] == ["a.0", "layers.00.w", "layers.01.w"]
    assert sorted(flat)[-1] == "layers.11.w"
    back = scan.nest_params(flat)
    assert len(back["layers"]) == 12 and "b" not in back


def test_steps_match_reference():
    jcfg = jget_smoke_config("stablelm-3b")
    pcfg = configs.get_smoke_config("stablelm-3b")
    gen = torch.Generator().manual_seed(0)
    p = steps.init_model_params(gen, pcfg)
    jp = jax.eval_shape(lambda k: jsteps.init_model_params(k, jcfg), KEY)
    assert [tuple(v.shape) for _, v in sorted(scan.flat_params(p).items())] \
        == [tuple(v.shape) for v in jax.tree_util.tree_leaves(jp)]
    st = steps.init_stacked_params(torch.Generator().manual_seed(0), pcfg, 3)
    for k, v in scan.flat_params(st).items():
        assert v.shape[0] == 3 and torch.equal(v[2], scan.flat_params(p)[k])
    assert steps._use_scan(pcfg) and steps.make_optimizer(pcfg).init(
        scan.flat_params(p))["mu"] is not None
    pod = dataclasses.replace(pcfg, fl_client_axis="pod")
    assert steps.make_optimizer(pod).init(scan.flat_params(p))["mu"] is None
    # the mesh case builders build on the one-process host mesh
    host = pmesh.make_host_mesh("cpu")
    assert callable(steps.build_train_step(pcfg, host))
    assert steps.build_case(pcfg, host, "decode_32k").meta == {
        "kind": "decode", "cache_len": 32768}


@pytest.mark.parametrize("preset", ["cpu-small", "lm-100m", "full"])
def test_presets_match_reference(preset):
    got = train.preset_config("stablelm-3b", preset)
    want = jtrain.preset_config("stablelm-3b", preset)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# federated LM training against the reference


M, SEED = 4, 0
FL_KW = dict(rounds=2, local_steps=1, batch_size=2, eval_every=1,
             sigma_batches=2)


TINY = dict(n_layers=1, d_model=64, vocab=128, max_seq=64)


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    """The reference's 2-round LM run (ucfl_k2 over 4 clients, qsgd:8)
    and the port's on the same data, params0 and draws."""
    jcfg = jreduced(jget_config("stablelm-3b"), **TINY)
    pcfg = configs.reduced(configs.get_config("stablelm-3b"), **TINY)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    jfed = jtrain.lm_federated_data(jax.random.PRNGKey(3), M, pool=6,
                                    n_val=4, seq=16, vocab=jcfg.vocab_size)
    lm_loss = jsteps._loss_fn(jcfg, remat=False)
    kinit = jax.random.split(jax.random.PRNGKey(SEED))[1]
    params0 = _jtree(jsteps.init_model_params(kinit, jcfg))
    from repro.fl import Channel as JChannel
    from repro_torch.fl import Channel
    want = j_run("ucfl_k2", jfed, fl=JFLConfig(**FL_KW, momentum=0.9,
                                              opt_state_dtype="param"),
                 model_init=lambda k: jsteps.init_model_params(k, jcfg),
                 loss_fn=lambda p, b: lm_loss(p, {"tokens": b["x"]}),
                 acc_fn=lambda p, b: -lm_loss(p, {"tokens": b["x"]})[0],
                 system=J_SYSTEMS["wireless_slow"], keep_state=True,
                 channel=JChannel(codec="qsgd:8"), superstep=False,
                 seed=SEED)
    fed = fed_from_numpy(*(np.asarray(a) for a in jfed), device="cpu")
    loss_fn, acc_fn = train.lm_fns(pcfg)
    got = run_federated(
        "ucfl_k2", fed, fl=FLConfig(**FL_KW, momentum=0.9,
                                    opt_state_dtype="param"),
        model_init=lambda gen: lm_view_from_numpy(params0, "cpu"),
        loss_fn=loss_fn, acc_fn=acc_fn, system=SYSTEMS["wireless_slow"],
        keep_state=True, channel=Channel(codec="qsgd:8"), seed=SEED,
        draws=ReplayDraws(SEED, FL_KW["rounds"]), device="cpu")
    path = tmp_path_factory.mktemp("lmckpt")
    return jcfg, pcfg, want, got, path


def test_lm_run_federated_matches_reference(lm_runs):
    jcfg, pcfg, want, got, _ = lm_runs
    assert got.rounds == want.rounds
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert got.time == want.time
    assert [tuple(c) for c in got.comm_bits] == \
        [tuple(c) for c in want.comm_bits]
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=RTOL)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=RTOL)
    np.testing.assert_array_equal(got.extras.assignment,
                                  want.extras.assignment)
    np.testing.assert_allclose(got.extras.mixing_matrix,
                               want.extras.mixing_matrix, atol=1e-5)
    wflat = scan.flat_params(_jtree(want.final_params))
    assert sorted(wflat) == sorted(got.final_params)
    outside = total = 0
    for k, v in wflat.items():
        d = np.abs(_np(got.final_params[k]) - v)
        # qsgd:8's stochastic rounding may flip a level where the two
        # packages' updates differ in the last bits
        outside += int((d > 1e-5 + 1e-4 * np.abs(v)).sum())
        total += v.size
        assert d.max() <= 1e-2, (k, d.max())
    assert outside <= total // 1000, (outside, total)


def test_lm_checkpoint_file_matches_reference(lm_runs):
    """The CLI's checkpoint of a run's final state, written from the
    reference's values carried into the port's flat view, is the
    reference's file byte for byte."""
    jcfg, pcfg, want, _, path = lm_runs
    j_save_train_state(str(path / "want.ckpt"), 2,
                       jax.device_get(want.final_params),
                       jax.device_get(want.final_opt_state),
                       extra={"arch": jcfg.name, "algorithm": "ucfl_k2"})

    class Kept:
        final_params = lm_view_from_numpy(_jtree(want.final_params), "cpu")
        final_opt_state = lm_opt_state_from_numpy(
            _jtree(want.final_opt_state), "cpu")

    train.save_checkpoint(str(path / "got.ckpt"), 2, Kept, pcfg, "ucfl_k2")
    assert (path / "got.ckpt").read_bytes() == \
        (path / "want.ckpt").read_bytes()
