"""The port's hierarchical edge tier against the reference, on the CPU.

Counterparts of the `HostVmap` cases of tests/test_hierarchy.py (its
mesh cases wait for the mesh placement).  The reference's label-shift
arrays, a narrow LeNet and the reference's params0 (the same bits in
both packages) feed both; the port's draws replay the reference's key
chain (`ReplayDraws`: the device slots, the edge codec noise and the
device-dropout coins included), and the reference runs eventful, which
its own tests pin bitwise to its fused engine.

Tolerances:
* exact: History.comm, time, comm_bits and ``extra["hierarchy"]``;
  `resolve_fleet_spec`, `partition_fleet_data` and `FleetPlan` (counts,
  keep mask, participation, user_time, bits);
* within one argmax flip (1/(m·n_val)): accuracies;
* final params within rtol 1e-4 / atol 1e-5 (tests/test_torch_engine.py's
  and tests/test_torch_channel_engine.py's tolerance).  A qsgd edge run
  may also hold a stochastic-rounding level flip: a last-bit difference
  in the local update moves ``floor(v·s/absmax + u)`` by one level where
  that value lies within ~1e-6 of an integer (the two-level books run
  has one at 2.4e-7 in its last round), so at most 0.1 % of its elements
  may lie outside, none by more than 1e-2 (a 4-bit level of a device
  row, weighted), as chip_smoke.py's async agreement allows for qsgd:8.
  Not bitwise either way: XLA's flushes of subnormal results in the EF
  algebra are not the port's (ROADMAP Queue 3.1).
* the uniform ``edge_weights`` hook: its final params through a
  one-round run; the four-round run's trajectory passes a point where
  the reference's own update is discontinuous (from its round-1 state
  its round-2 update differs by 1.4e-4 from its update of the port's
  round-1 state, which lies within 4e-7 of it, while both packages'
  updates of one state agree within 6e-8), so that run is held on the
  exact fields and the accuracies.

Port-internal anchors, bitwise on the CPU: ``devices_per_user=1``
against the port's flat run (six traceable strategies fused, cfl
eventful, sampler + channel, async lockstep and partial), two-level
fused against eventful (history, params and the final `EdgeState`), the
host-weighted fallback against the mean run, and the identity
``edge_weights`` override against the default.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.federated import scenario_label_shift as j_label_shift
from repro.fl import AsyncConfig as JAsyncConfig
from repro.fl import Channel as JChannel
from repro.fl import FLConfig as JFLConfig
from repro.fl import HierarchyConfig as JHierarchyConfig
from repro.fl import UniformFraction as JUniformFraction
from repro.fl import run_async as j_run_async
from repro.fl import run_federated as j_run
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.fl import hierarchy as jh
from repro.fl.strategies.fedavg import FedAvg as JFedAvg
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.fl import (SYSTEMS, AsyncConfig, Channel, FLConfig,
                            HierarchyConfig, MeshShardMap, PagingConfig,
                            UniformFraction, run_async, run_federated,
                            superstep_support)
from repro_torch.fl import hierarchy as th
from repro_torch.fl.placement.graphs import leaves
from repro_torch.fl.strategies import FedAvg, get_strategy
from test_torch_engine import ReplayDraws

SEED = 0
M, N = 4, 500
FL_KW = dict(rounds=4, local_steps=2, batch_size=16, eval_every=2)
FL = FLConfig(**FL_KW)
NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
TRACEABLE = ["fedavg", "local", "oracle", "ucfl", "ucfl_k2", "fedfomo"]
FLAT = dict(devices_per_user=1)
TWO_LEVEL = dict(devices_per_user="ragged:2-4", edge_codec="qsgd:4",
                 edge_link="tiered:4", edge_latency=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def case():
    jfed = j_label_shift(jax.random.PRNGKey(0), n=N, m=M)
    kinit = jax.random.split(jax.random.PRNGKey(SEED))[1]
    params0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        jlenet.init_params, static_argnums=1)(kinit, NARROW))
    fed = fed_from_numpy(*(np.asarray(a) for a in jfed), device="cpu")
    return jfed, params0, fed


# ---------------------------------------------------------------------------
# one run, in either package, from one description


def _hier(pkg, kw):
    """Hierarchy kwargs -> the package's `HierarchyConfig`; None and a
    bare fleet spec pass through."""
    if not isinstance(kw, dict):
        return kw
    return (JHierarchyConfig if pkg == "ref" else HierarchyConfig)(**kw)


def _run(pkg, case, spec, hierarchy=None, *, system=None, buffer_k=None,
         sampler=None, codec=None, fl=None, strategy=None, **kw):
    """``spec`` (or ``strategy``, a per-package callable) with the
    hierarchy kwargs ``hierarchy`` in package ``pkg`` ("ref": the
    reference, eventful; "port": the port, its default engine unless
    ``superstep=`` says otherwise)."""
    jfed, params0, fed = case
    ref = pkg == "ref"
    fl_kw = dict(FL_KW, **(fl or {}))
    args = dict(
        fl=(JFLConfig if ref else FLConfig)(**fl_kw), keep_state=True,
        seed=SEED, hierarchy=_hier(pkg, hierarchy),
        system=(None if system is None
                else (J_SYSTEMS if ref else SYSTEMS)[system]))
    if strategy is not None:
        args["strategy"] = strategy(pkg)
    else:
        args["algorithm"] = spec
    if sampler is not None:
        args["sampler"] = (JUniformFraction if ref
                           else UniformFraction)(sampler)
    if codec is not None:
        args["channel"] = (JChannel if ref else Channel)(codec=codec)
    if ref:
        args["model_init"] = lambda k: jax.tree_util.tree_map(jnp.asarray,
                                                              params0)
        if buffer_k is not None:
            return j_run_async(fed=jfed, async_cfg=JAsyncConfig(
                buffer_k=buffer_k), **args, **kw)
        return j_run(fed=jfed, superstep=False, **args, **kw)
    args.update(model_init=lambda gen: tree_from_numpy(params0, "cpu"),
                device="cpu", draws=ReplayDraws(
                    SEED, fl_kw["rounds"], sampler_keys=sampler is not None))
    if buffer_k is not None:
        return run_async(fed=fed, async_cfg=AsyncConfig(buffer_k=buffer_k),
                         **args, **kw)
    return run_federated(fed=fed, **args, **kw)


class Runs:
    """Runs cached by name for the module: ``runs.ref(name)``,
    ``runs.port(name)`` and ``runs.both(name)`` of a description in
    `RUNS`."""

    def __init__(self, case):
        self.case, self._done = case, {}

    def _get(self, pkg, name, **over):
        key = (pkg, name, tuple(sorted(over.items())))
        if key not in self._done:
            spec, hierarchy, kw = RUNS[name]
            self._done[key] = _run(pkg, self.case, spec, hierarchy,
                                   **dict(kw, **over))
        return self._done[key]

    def ref(self, name):
        return self._get("ref", name)

    def port(self, name, **over):
        return self._get("port", name, **over)

    def both(self, name):
        return self.port(name), self.ref(name)


class EdgeAware(FedAvg):
    name = "edge_aware_torch_test"

    def edge_weights(self, w, n):
        return w


class UniformEdge(FedAvg):
    name = "uniform_edge_torch_test"

    def edge_weights(self, w, n):
        mask = (w > 0).to(torch.float32)
        return mask / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)


class JUniformEdge(JFedAvg):
    name = "uniform_edge_torch_test"

    def edge_weights(self, w, n):
        mask = (w > 0).astype(jnp.float32)
        return mask / jnp.maximum(mask.sum(axis=1, keepdims=True), 1.0)


def _host_mean(n, mask):
    wn = np.asarray(n, np.float64) * mask
    s = wn.sum(axis=1, keepdims=True)
    return np.where(s > 0, wn / np.maximum(s, 1e-12), 0.0).astype(np.float32)


@th.register_edge_aggregator
class HostMean(th.EdgeAggregator):
    name = "host_mean_torch_test"
    traceable = False

    def weights_host(self, n, mask):
        return _host_mean(n, mask)


@jh.register_edge_aggregator
class JHostMean(jh.EdgeAggregator):
    name = "host_mean_torch_test"
    traceable = False

    def weights_host(self, n, mask):
        return _host_mean(n, mask)


D3 = dict(devices_per_user=3)
RUNS = {
    **{f"{s}-flat": (s, None, dict(system="wired")) for s in TRACEABLE},
    **{f"{s}-FLAT": (s, FLAT, dict(system="wired")) for s in TRACEABLE},
    "cfl-flat": ("cfl", None, dict(fl=dict(cfl_min_rounds=1))),
    "cfl-FLAT": ("cfl", FLAT, dict(fl=dict(cfl_min_rounds=1))),
    **{f"ch-{h}": ("ucfl_k2", hk, dict(sampler=0.5, codec="qsgd:4",
                                       system="wireless_slow"))
       for h, hk in (("flat", None), ("FLAT", FLAT))},
    **{f"async{k}-{h}": ("fedavg", hk, dict(buffer_k=k))
       for k in (4, 2) for h, hk in (("flat", None), ("FLAT", FLAT))},
    "lat": ("fedavg", dict(devices_per_user=1, edge_latency=0.5),
            dict(system="wired")),
    "two": ("ucfl_k2", TWO_LEVEL, {}),
    "two-books": ("fedavg", TWO_LEVEL, dict(system="wired")),
    "hop": ("fedavg", dict(devices_per_user=2, edge_link="uniform",
                           edge_latency=0.25), dict(system="wired")),
    "fedavg-wired": ("fedavg", None, dict(system="wired")),
    "ef": ("fedavg", dict(devices_per_user=3, edge_codec="qsgd:2"), {}),
    "no-ef": ("fedavg", dict(devices_per_user=3, edge_codec="qsgd:2",
                             edge_error_feedback=False), {}),
    "d3": ("fedavg", D3, {}),
    "dropout": ("fedavg", dict(D3, device_dropout=0.5), {}),
    "drop": ("fedavg", dict(D3, edge_aggregator="drop_stragglers:0.4",
                            edge_link="tiered:4"), {}),
    "drop-mean": ("fedavg", dict(D3, edge_link="tiered:4"), {}),
    "async-drop": ("fedavg", dict(D3, edge_aggregator="drop_stragglers:0.4"),
                   dict(buffer_k=2)),
    "host": ("fedavg", dict(devices_per_user=2,
                            edge_aggregator="host_mean_torch_test"), {}),
    "d2": ("fedavg", dict(devices_per_user=2), {}),
    "hook": (None, dict(devices_per_user=2),
             dict(strategy=lambda pkg: EdgeAware())),
    "uniform-edge": (None, D3, dict(strategy=lambda pkg: (
        JUniformEdge() if pkg == "ref" else UniformEdge()))),
    "uniform-edge-1": (None, D3, dict(fl=dict(rounds=1), strategy=lambda pkg: (
        JUniformEdge() if pkg == "ref" else UniformEdge()))),
    "async-two": ("fedavg", TWO_LEVEL, dict(buffer_k=2, system="wired")),
    "async-wired": ("fedavg", None, dict(buffer_k=2, system="wired")),
    "bare2": ("fedavg", 2, {}),
}


@pytest.fixture(scope="module")
def runs(case):
    return Runs(case)


# ---------------------------------------------------------------------------
# comparisons


def _hext(h):
    ex = h.extra.get("hierarchy")
    if ex is None:
        return None
    return dict(ex, comm_bits=[tuple(c) for c in ex["comm_bits"]])


def assert_matches_reference(got, want, case, *, levels=False,
                             params=True):
    """The stated tolerances; ``levels`` for a qsgd edge run (level flips
    allowed), ``params=False`` to hold the exact fields and the
    accuracies only."""
    flip = 1.0 / (M * case[2].x_val.shape[1]) + 1e-6
    assert got.rounds == want.rounds
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert got.time == want.time
    assert ([tuple(c) for c in got.comm_bits]
            == [tuple(c) for c in want.comm_bits])
    assert _hext(got) == _hext(want)
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip)
    if not params:
        return
    gp = tree_to_numpy(got.final_params)
    outside = total = 0
    for k, v in want.final_params.items():
        v = np.asarray(v)
        if not levels:
            np.testing.assert_allclose(gp[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        d = np.abs(gp[k] - v)
        outside += int((d > 1e-5 + 1e-4 * np.abs(v)).sum())
        total += v.size
        assert d.max() <= 1e-2, (k, d.max())
    assert outside <= total // 1000, (outside, total)


def assert_history_equal(a, b):
    for f in ("rounds", "mean_acc", "worst_acc", "time", "comm",
              "comm_bits"):
        assert getattr(a, f) == getattr(b, f), f


def assert_tree_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the flat-parity anchor: a degenerate hierarchy is the flat engine


@pytest.mark.parametrize("spec", TRACEABLE)
def test_flat_parity_traceable(spec, runs, case):
    h0, h1 = runs.port(f"{spec}-flat"), runs.port(f"{spec}-FLAT")
    assert_history_equal(h1, h0)
    assert_tree_bitwise(h1.final_params, h0.final_params)
    assert h1.extra["hierarchy"]["d_max"] == 1
    assert_matches_reference(h1, runs.ref(f"{spec}-FLAT"), case)


def _mesh():
    return MeshShardMap(schedule="shard_map_streams", device="cpu")


@pytest.mark.parametrize("spec", TRACEABLE)
def test_flat_parity_traceable_mesh(spec, runs, case):
    """The mesh half of the reference's `test_flat_parity_traceable` (one
    rank): the degenerate hierarchy is the flat mesh run, and both are
    the `HostVmap` runs, bitwise."""
    h0 = runs.port(f"{spec}-flat", placement=_mesh())
    h1 = runs.port(f"{spec}-FLAT", placement=_mesh())
    assert_history_equal(h1, h0)
    assert_tree_bitwise(h1.final_params, h0.final_params)
    assert h1.extra["hierarchy"]["d_max"] == 1
    host = runs.port(f"{spec}-FLAT")
    assert_history_equal(h1, host)
    assert_tree_bitwise(h1.final_params, host.final_params)


def test_two_level_host_mesh_agree(runs, case):
    """The two-level qsgd:4 edge run on the mesh: its edge codec runs the
    mesh's ``"jnp"`` backend, which for qsgd is the kernels' path, so the
    mesh run is the `HostVmap` run bitwise (the reference asserts atol
    1e-5), and it holds against the reference at the edge tolerances."""
    h_m = runs.port("two", placement=_mesh())
    h_h = runs.port("two")
    assert_history_equal(h_m, h_h)
    assert_tree_bitwise(h_m.final_params, h_h.final_params)
    assert_tree_bitwise(h_m.final_opt_state, h_h.final_opt_state)
    assert_matches_reference(h_m, runs.ref("two"), case, levels=True)


def test_flat_parity_eventful_cfl(runs, case):
    h0, h1 = runs.port("cfl-flat"), runs.port("cfl-FLAT")
    assert_history_equal(h1, h0)
    assert_tree_bitwise(h1.final_params, h0.final_params)
    assert_matches_reference(h1, runs.ref("cfl-FLAT"), case)


def test_flat_parity_sampler_and_channel(runs, case):
    """Participation rollback (the `EdgeState` rides `placement.select`)
    and the server hop's codec keep the anchor."""
    h0, h1 = runs.port("ch-flat"), runs.port("ch-FLAT")
    assert_history_equal(h1, h0)
    assert_tree_bitwise(h1.final_params, h0.final_params)
    assert_tree_bitwise(h1.final_residual, h0.final_residual)
    assert_matches_reference(h1, runs.ref("ch-FLAT"), case)


@pytest.mark.parametrize("buffer_k", [4, 2], ids=["lockstep", "partial"])
def test_flat_parity_async(buffer_k, runs, case):
    """Async flat parity, partial events included, where the `EdgeState`
    rows ride `HostVmap`'s cohort gather and scatter."""
    h0, h1 = runs.port(f"async{buffer_k}-flat"), runs.port(
        f"async{buffer_k}-FLAT")
    assert_history_equal(h1, h0)
    assert_tree_bitwise(h1.final_params, h0.final_params)
    assert_matches_reference(h1, runs.ref(f"async{buffer_k}-FLAT"), case)


def test_flat_latency_shifts_clock_only(runs, case):
    """D = 1 with edge latency: the values stay bitwise the flat run's
    and every eval point's clock gains exactly rounds_elapsed · latency."""
    h0, h1 = runs.port("fedavg-wired"), runs.port("lat")
    assert h1.mean_acc == h0.mean_acc
    assert_tree_bitwise(h1.final_params, h0.final_params)
    for rnd, t0, t1 in zip(h0.rounds, h0.time, h1.time):
        np.testing.assert_allclose(t1 - t0, (rnd + 1) * 0.5, rtol=1e-12)
    assert_matches_reference(h1, runs.ref("lat"), case)


# ---------------------------------------------------------------------------
# two-level rounds: values, engines and the per-hop books


def test_two_level_fused_matches_eventful(runs, case):
    h_ss = runs.port("two")
    h_ev = runs.port("two", superstep=False)
    assert_history_equal(h_ss, h_ev)
    assert _hext(h_ss) == _hext(h_ev)
    assert_tree_bitwise(h_ss.final_params, h_ev.final_params)
    assert isinstance(h_ss.final_opt_state, th.EdgeState)
    assert h_ss.final_opt_state.edge_ef is not None
    assert_tree_bitwise(h_ss.final_opt_state, h_ev.final_opt_state)
    want = runs.ref("two")
    assert_matches_reference(h_ss, want, case, levels=True)
    for part in ("dev_opt", "edge_ef"):
        got = tree_to_numpy(getattr(h_ss.final_opt_state, part))
        ref = getattr(want.final_opt_state, part)
        for k in ("conv1_w", "out_b"):
            g = got["mu"][k] if part == "dev_opt" else got[k]
            r = ref["mu"][k] if part == "dev_opt" else ref[k]
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{part} {k}")


def test_two_level_extra_books(runs, case):
    h, want = runs.both("two-books")
    ex = h.extra["hierarchy"]
    counts = ex["devices_per_user"]
    assert len(counts) == M and all(2 <= c <= 4 for c in counts)
    assert ex["d_max"] == max(counts)
    assert ex["edge_codec"] == "qsgd:4" and ex["edge_aggregator"] == "mean"
    assert len(ex["comm_bits"]) == FL.rounds
    assert ex["edge_dl_bits_total"] > 0 and ex["edge_ul_bits_total"] > 0
    assert all(t >= 0.5 for t in ex["user_edge_time"])
    assert_matches_reference(h, want, case, levels=True)


def test_two_level_clock_charges_edge_hop(runs, case):
    """Identity edge codec and a uniform edge link: every device's hop is
    exactly (1 + ρ)·T_dl, so each round's clock gains latency + 1 + ρ
    over the flat run."""
    rho = SYSTEMS["wired"].rho
    h0, h1 = runs.port("fedavg-wired"), runs.port("hop")
    for rnd, t0, t1 in zip(h0.rounds, h0.time, h1.time):
        np.testing.assert_allclose(t1 - t0, (rnd + 1) * (0.25 + 1.0 + rho),
                                   rtol=1e-9)
    assert_matches_reference(h1, runs.ref("hop"), case)


def test_edge_error_feedback_changes_values(runs, case):
    h_ef, h_no = runs.port("ef"), runs.port("no-ef")
    assert h_ef.mean_acc != h_no.mean_acc
    assert all(np.isfinite(h_ef.mean_acc + h_no.mean_acc))
    assert_matches_reference(h_ef, runs.ref("ef"), case, levels=True)
    assert_matches_reference(h_no, runs.ref("no-ef"), case, levels=True)


def test_device_dropout_runs_and_differs(runs, case):
    h0, h1 = runs.port("d3"), runs.port("dropout")
    assert h0.mean_acc != h1.mean_acc
    assert all(np.isfinite(h1.mean_acc))
    assert_matches_reference(h1, runs.ref("dropout"), case)


# ---------------------------------------------------------------------------
# edge aggregators


def test_drop_stragglers_static_keep(runs, case):
    kw = RUNS["drop"][1]
    p0 = {"w": np.zeros(8, np.float32)}
    jplan = jh.fleet_plan(JHierarchyConfig(**kw), M, p0, J_SYSTEMS["wired"])
    plan = th.fleet_plan(HierarchyConfig(**kw), M,
                         {"w": torch.zeros(8)}, SYSTEMS["wired"])
    assert not plan.row_local and not jplan.row_local
    # 3 devices · frac 0.4: exactly one dropped a user, the slowest
    assert (plan.participating.sum(axis=1) == 2).all()
    for f in ("counts", "valid", "keep", "participating", "pc_bits",
              "user_time"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f),
                                      err_msg=f)
    assert plan.payload_bits == jplan.payload_bits
    assert plan.user_time.tolist() == jplan.user_time.tolist()
    h_drop, h_mean = runs.port("drop"), runs.port("drop-mean")
    # one uplink less a user a round
    assert (h_drop.extra["hierarchy"]["edge_ul_bits_total"]
            < h_mean.extra["hierarchy"]["edge_ul_bits_total"])
    assert all(np.isfinite(h_drop.mean_acc))
    assert_matches_reference(h_drop, runs.ref("drop"), case)
    assert_matches_reference(h_mean, runs.ref("drop-mean"), case)


def test_drop_stragglers_async_partial_full_width(runs, case):
    """row_local=False sends async partial events through the base
    full-width cohort path: finite, books charged, the reference's run."""
    h = runs.port("async-drop")
    assert all(np.isfinite(h.mean_acc))
    assert len(h.extra["hierarchy"]["comm_bits"]) == FL.rounds
    assert_matches_reference(h, runs.ref("async-drop"), case)


def test_non_traceable_aggregator_falls_back_eventful(runs, case):
    """A host-side aggregator blocks fusion (`superstep_support` names
    it), runs eventful, and, its host weights equal to the mean's,
    reproduces the mean run bitwise."""
    hc = HierarchyConfig(**RUNS["host"][1])
    ok, why = superstep_support(get_strategy("fedavg"), None, hierarchy=hc)
    assert not ok and "host_mean_torch_test" in why
    with pytest.raises(ValueError, match="cannot fuse"):
        run_federated("fedavg", case[2], fl=FL, superstep=True,
                      hierarchy=hc, device="cpu")
    h_host = runs.port("host")
    h_mean = runs.port("d2", superstep=False)
    assert h_host.mean_acc == h_mean.mean_acc
    assert_tree_bitwise(h_host.final_params, h_mean.final_params)
    assert_matches_reference(h_host, runs.ref("host"), case)


def test_strategy_edge_weights_hook(runs, case):
    """An overridden `Strategy.edge_weights` is threaded into the edge
    combine: the identity override gives the default run bitwise, a
    uniform one other params, as the reference's does."""
    h_hook, h_base = runs.port("hook"), runs.port("d2")
    assert h_hook.mean_acc == h_base.mean_acc
    assert_tree_bitwise(h_hook.final_params, h_base.final_params)
    h_uni, h_def = runs.port("uniform-edge"), runs.port("d3")
    assert all(np.isfinite(h_uni.mean_acc))
    assert any(not torch.equal(a, b) for a, b in
               zip(leaves(h_uni.final_params), leaves(h_def.final_params)))
    assert_matches_reference(h_uni, runs.ref("uniform-edge"), case,
                             params=False)
    assert_matches_reference(runs.port("uniform-edge-1"),
                             runs.ref("uniform-edge-1"), case)
    assert_matches_reference(h_def, runs.ref("d3"), case)


def test_edge_aggregator_registry():
    for get in (th.get_edge_aggregator, jh.get_edge_aggregator):
        assert get("mean").spec == "mean"
        agg = get("drop_stragglers:0.25")
        assert agg.spec == "drop_stragglers:0.25" and agg.traceable
        with pytest.raises(ValueError, match="mean"):
            get("meann")
        with pytest.raises(ValueError):
            get("drop_stragglers:1.5")
        with pytest.raises(ValueError, match="takes no parameter"):
            get("mean:0.5")
    w = th.MeanEdge().weights(torch.tensor([[3.0, 1.0, 0.0], [0.0, 0.0, 0.0]]),
                              torch.tensor([[True, True, True],
                                            [True, False, True]]))
    jw = jh.MeanEdge().weights(jnp.asarray([[3.0, 1.0, 0.0],
                                            [0.0, 0.0, 0.0]]),
                               jnp.asarray([[True, True, True],
                                            [True, False, True]]))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# fleet resolution and data partitioning


@pytest.mark.parametrize("spec,m,seed", [
    (3, 4, 0), ("uniform:2", 3, 0), ("ragged:2-5", 16, 1),
    ("ragged:2-4", 20, 0), ((1, 2, 3), 3, 0)])
def test_resolve_fleet_spec(spec, m, seed):
    counts = th.resolve_fleet_spec(spec, m, seed=seed)
    np.testing.assert_array_equal(counts,
                                  jh.resolve_fleet_spec(spec, m, seed=seed))
    assert counts.dtype == np.int64 and counts.shape == (m,)
    if spec == "ragged:2-5":
        assert counts.min() >= 2 and counts.max() <= 5
        assert counts.max() > counts.min()          # actually ragged
    for bad in (((1, 2), 3), (0, 2), ("ragged:5", 2), ("ragged:3-2", 2),
                ("nope:2", 2)):
        with pytest.raises(ValueError):
            th.resolve_fleet_spec(*bad)
        with pytest.raises(ValueError):
            jh.resolve_fleet_spec(*bad)


def test_hierarchy_config_validation():
    for kw in (dict(device_dropout=1.0), dict(edge_latency=-1.0),
               dict(edge_aggregator="nope"), dict(edge_codec="nope"),
               dict(devices_per_user=0)):
        with pytest.raises(ValueError):
            HierarchyConfig(**kw)
        with pytest.raises(ValueError):
            JHierarchyConfig(**kw)
    with pytest.raises(ValueError, match="mean"):
        HierarchyConfig(edge_aggregator="nope")
    assert th.resolve_hierarchy(None) is None
    assert th.resolve_hierarchy(2).devices_per_user == 2
    assert th.resolve_hierarchy("uniform:3").devices_per_user == "uniform:3"
    assert th.resolve_hierarchy([1, 2]).devices_per_user == (1, 2)
    cfg = HierarchyConfig(devices_per_user=1)
    assert th.resolve_hierarchy(cfg) is cfg
    for bad in (2.5, object()):
        with pytest.raises(TypeError, match="cannot resolve hierarchy"):
            th.resolve_hierarchy(bad)
    # value semantics: equal configs hash equal (the fleet-update cache)
    a = HierarchyConfig(**TWO_LEVEL)
    b = HierarchyConfig(**TWO_LEVEL)
    assert a == b and hash(a) == hash(b)
    assert hash(a) != hash(HierarchyConfig(**dict(TWO_LEVEL,
                                                  edge_codec="qsgd:8")))


@pytest.mark.parametrize("counts,d_max", [((1, 2, 3, 2), 3),
                                          ((4, 3, 3, 2), 4)])
def test_partition_fleet_data(case, counts, d_max):
    jfed, _, fed = case
    counts = np.asarray(counts, np.int64)
    x, y, n = th.partition_fleet_data(fed, counts, d_max)
    jx, jy, jn = jh.partition_fleet_data(jfed, counts, d_max)
    np.testing.assert_array_equal(x, np.asarray(jx))
    np.testing.assert_array_equal(y, np.asarray(jy))
    np.testing.assert_array_equal(n, np.asarray(jn))
    assert x.shape[:2] == (M, d_max) and y.shape[:2] == (M, d_max)
    # the true sizes shard without loss: the devices' sum is the flat size
    np.testing.assert_array_equal(n.sum(axis=1), fed.n.numpy())
    # invalid device slots carry zero true samples
    assert n[0, counts[0]:].sum() == 0
    # every device's real rows are a strided shard of the user's data
    n1 = int(fed.n[1])
    dev0 = x[1, 0][: int(n[1, 0])]
    np.testing.assert_array_equal(dev0, fed.x[1].numpy()[:n1][0::counts[1]])
    # d_max == 1 gives views of the flat tensors
    x1, y1, n1 = th.partition_fleet_data(fed, np.ones(M, np.int64), 1)
    assert x1.data_ptr() == fed.x.data_ptr() and x1.shape[1] == 1
    assert torch.equal(n1[:, 0], fed.n) and torch.equal(y1[:, 0], fed.y)


# ---------------------------------------------------------------------------
# async two-level and composition guards


def test_async_two_level(runs, case):
    h2, h0 = runs.port("async-two"), runs.port("async-wired")
    # both hops charged: every arrival carries its edge sub-round time
    assert h2.time[-1] > h0.time[-1]
    ex = h2.extra["hierarchy"]
    assert len(ex["comm_bits"]) == FL.rounds
    assert ex["edge_ul_bits_total"] > 0
    assert_matches_reference(h2, runs.ref("async-two"), case, levels=True)


def test_hierarchy_rejects_paging(case):
    fed = case[2]
    flat = HierarchyConfig(**FLAT)
    pg = PagingConfig(cohort=2)
    with pytest.raises(TypeError, match="paging"):
        run_federated("fedavg", fed, fl=FL, hierarchy=flat, paging=pg,
                      device="cpu")
    with pytest.raises(TypeError, match="paging"):
        run_async("fedavg", fed, fl=FL, hierarchy=flat, paging=pg,
                  device="cpu")


def test_run_federated_accepts_bare_fleet_specs(runs, case):
    h = runs.port("bare2")
    assert h.extra["hierarchy"]["d_max"] == 2
    h_uni = _run("port", case, "fedavg", "uniform:2")
    assert_history_equal(h_uni, h)
    assert _hext(h_uni) == _hext(h)
    assert_tree_bitwise(h_uni.final_params, h.final_params)
    assert_matches_reference(h, runs.ref("bare2"), case)


# ---------------------------------------------------------------------------
# the fleet-update cache and the draws' snapshots


def test_fleet_step_cache_keys_model_width(case):
    """One hierarchy configuration and m over two model widths in one
    process: the fleet update sizes its edge noise from its plan, so the
    full LeNet run after a narrow one gets its own step and equals the
    same run from empty caches, bitwise."""
    from repro_torch.fl.simulator import default_model_init
    fed, params0 = case[2], case[1]
    hc = HierarchyConfig(**TWO_LEVEL)
    fl = FLConfig(**dict(FL_KW, rounds=2))

    def go(init):
        return run_federated("ucfl_k2", fed, fl=fl, hierarchy=hc,
                             model_init=init, keep_state=True, seed=SEED,
                             device="cpu")

    narrow = go(lambda gen: tree_from_numpy(params0, "cpu"))
    full = go(default_model_init(fed))
    size = lambda h: sum(t.numel() for t in leaves(h.final_params))
    assert size(full) > size(narrow)
    th.cached_fleet_update.cache_clear()
    fresh = go(default_model_init(fed))
    assert_history_equal(full, fresh)
    assert _hext(full) == _hext(fresh)
    assert_tree_bitwise(full.final_params, fresh.final_params)


def test_draws_load_snapshot_without_edge_stream():
    """A `TorchDraws` snapshot written before the edge stream existed (a
    paged run's) loads: its streams resume where they stood, and the
    edge stream is left where it stands."""
    from repro_torch.fl import TorchDraws
    n = torch.full((3,), 20.0)
    a = TorchDraws(5, "cpu")
    a.batch_indices(0, n, 20, 4, 2)
    state = {k: v for k, v in a.state_dict().items() if k != "edge"}
    want = a.batch_indices(1, n, 20, 4, 2)
    b, c = TorchDraws(9, "cpu"), TorchDraws(9, "cpu")
    b.edge_noise(0, 3, 0, (2, 2))
    c.edge_noise(0, 3, 0, (2, 2))
    b.load_state_dict(state)
    assert torch.equal(b.batch_indices(1, n, 20, 4, 2), want)
    assert torch.equal(b.edge_noise(1, 3, 0, (3, 5)),
                       c.edge_noise(1, 3, 0, (3, 5)))
