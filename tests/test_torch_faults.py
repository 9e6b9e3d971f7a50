"""The port's fault/defense layer against the reference, on the CPU.

Counterparts of tests/test_faults.py: the spec grammar and its errors,
the plan's Byzantine set (numpy, the same bits as the reference's), the
robust-aggregator registry, each defense on hand-made deltas against the
reference's (the order statistics bitwise), bit-rot on an int32 view,
quarantine mass, faults-off parity, then four faulted configurations
(the reference test's four ``kw``) with the port's fused run bitwise its
eventful run and the port equal to the reference's eventful run
(``superstep=False``: the reference's own fused and eventful runs differ
for its first ``kw``, red on the reference itself) at
tests/test_torch_engine.py's tolerances, the clock, comm, comm bits and
``extra["faults"]`` exact.  Then all-crash keeps the init, NaN warns
undefended and stays finite defended, the quorum skips and validates,
and `pop_with_retries`' backoff ladder, one fake clock driving both
packages' functions, then both packages' real `VirtualClock`s.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.federated import scenario_label_shift as j_label_shift
from repro.fl import Channel as JChannel
from repro.fl import FLConfig as JFLConfig
from repro.fl import UniformFraction as JUniformFraction
from repro.fl import run_federated as j_run
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.fl.faults import get_robust_aggregator as j_get_robust
from repro.fl.faults import inject_values as j_inject_values
from repro.fl.faults import resolve_fault_plan as j_resolve_fault_plan
from repro.fl.faults.defense import screen_and_defend as j_screen_and_defend
from repro.fl.faults.runtime import FaultMeter as JFaultMeter
from repro.fl.faults.runtime import pop_with_retries as j_pop_with_retries
from repro.fl.runtime import VirtualClock as JVirtualClock
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.fl import (SYSTEMS, Channel, FaultConfig, FLConfig,
                            NonFiniteEvalWarning, UniformFraction,
                            get_robust_aggregator, parse_fault_spec,
                            resolve_fault_plan, run_federated)
from repro_torch.fl.faults import (FaultMeter, inject_values,
                                   pop_with_retries, screen_and_defend)
from repro_torch.fl.runtime import VirtualClock
from repro_torch.fl.strategies import quarantine_reweight
from repro_torch.models import lenet
from test_torch_engine import ReplayDraws

SEED = 0
M, N = 8, 400
FL_KW = dict(rounds=5, local_steps=2, batch_size=16, eval_every=2)
FL = FLConfig(**FL_KW)
NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)


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


def run(case, spec="fedavg", fl=FL, **kw):
    """A port run of the module's scenario from the reference's params0."""
    _, params0, fed = case
    return run_federated(spec, fed, fl=fl,
                         model_init=lambda gen: tree_from_numpy(params0,
                                                                "cpu"),
                         system=SYSTEMS["wired"], keep_state=True, seed=SEED,
                         device="cpu", **kw)


def _assert_same_run(a, b):
    assert (a.rounds, a.mean_acc, a.worst_acc, a.time, a.comm,
            a.comm_bits) == (b.rounds, b.mean_acc, b.worst_acc, b.time,
                             b.comm, b.comm_bits)
    assert a.extra.get("faults") == b.extra.get("faults")
    for part in ("final_params", "final_residual"):
        ta, tb = getattr(a, part), getattr(b, part)
        assert (ta is None) == (tb is None)
        for k in ta or {}:
            assert torch.equal(ta[k].view(torch.int32),
                               tb[k].view(torch.int32)), (part, k)


# ---------------------------------------------------------------------------
# spec grammar, plan resolution, registry


def test_fault_spec_roundtrip():
    spec = "crash:0.1,nan:0.05,byz:0.25:scale:5,bitrot:0.2:0.001,seed:7"
    cfg = parse_fault_spec(spec)
    assert cfg == FaultConfig(crash=0.1, nan=0.05, byz=0.25,
                              byz_mode="scale", byz_scale=5.0, bitrot=0.2,
                              bitrot_density=0.001, seed=7)
    assert parse_fault_spec(cfg.spec) == cfg
    assert cfg.spec == j_resolve_fault_plan(spec, 8).cfg.spec
    assert parse_fault_spec("none") == FaultConfig()
    assert FaultConfig().spec == "none"


@pytest.mark.parametrize("bad", ["crash", "crash:2.0", "byz:0.2:evil",
                                 "byz:0.2:scale:0", "gamma:0.1",
                                 "bitrot:0.1:0", "seed:x"])
def test_fault_spec_errors(bad):
    with pytest.raises(ValueError):
        resolve_fault_plan(bad, 8)
    with pytest.raises(ValueError):
        j_resolve_fault_plan(bad, 8)


@pytest.mark.parametrize("spec,m", [("byz:0.25,seed:3", 8),
                                    ("byz:0.25:sign_flip", 20),
                                    ("byz:0.4:scale:3,seed:11", 33),
                                    ("crash:0.5", 8)])
def test_fault_plan_resolution_matches_reference(spec, m):
    """The Byzantine set comes from numpy ``default_rng(seed)`` in both
    packages: the same clients, with no replay."""
    plan, jplan = resolve_fault_plan(spec, m), j_resolve_fault_plan(spec, m)
    np.testing.assert_array_equal(plan.byz_mask, jplan.byz_mask)
    np.testing.assert_array_equal(plan.byz_row(), jplan.byz_row())
    assert plan.value_faults == jplan.value_faults
    assert [plan.arrival_crash() for _ in range(20)] == \
        [jplan.arrival_crash() for _ in range(20)]
    assert resolve_fault_plan(None, m) is None
    assert resolve_fault_plan("crash:0.0,byz:0", m) is None
    idx = np.array([1, 0, 3])
    assert (plan.byz_row(idx) == plan.byz_mask[idx].astype(np.float32)).all()


def test_robust_agg_registry():
    assert get_robust_aggregator(None) is None
    assert get_robust_aggregator("none") is None
    assert get_robust_aggregator("clip:2.5").c == 2.5
    assert get_robust_aggregator("trimmed_mean:0.2").f == 0.2
    assert get_robust_aggregator("krum:0.3").frac == 0.3
    assert get_robust_aggregator("median").spec == "median"
    for bad in ["huber", "median:0.2", "trimmed_mean:0.7", "clip:-1",
                "none:1"]:
        with pytest.raises(ValueError):
            get_robust_aggregator(bad)


# ---------------------------------------------------------------------------
# the defense on hand-made deltas, against the reference


def _delta_stack(rng, m=11, d=37):
    """(m, d) deltas: honest rows around 1, two far outliers, a NaN row, an
    inf row, and ties in some columns (an even count of survivors)."""
    delta = rng.normal(1.0, 0.05, (m, d)).astype(np.float32)
    delta[3] = -40.0
    delta[7] = 80.0
    delta[5, 2] = np.nan
    delta[9, 30] = np.inf
    delta[:, 11] = delta[0, 11]              # a column of ties
    return delta


@pytest.mark.parametrize("spec", ["median", "trimmed_mean:0.25",
                                  "trimmed_mean:0.1", "clip:3", "krum:0.2",
                                  "krum:0.3"])
def test_defense_matches_reference(spec):
    """Screen + transform on the same (m, D) stack: survival rows exact,
    the order statistics' deltas bitwise, clip's within f32 rounding of
    the row norm."""
    delta = _delta_stack(np.random.default_rng(len(spec)))
    jout, jkeep = j_screen_and_defend(
        j_get_robust(spec), {"w": jnp.asarray(delta)},
        {"w": jnp.zeros_like(jnp.asarray(delta))})
    out, keep = screen_and_defend(
        get_robust_aggregator(spec), {"w": torch.from_numpy(delta)},
        {"w": torch.zeros(delta.shape)})
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep[5] == 0 and keep[9] == 0          # non-finite: quarantined
    got, want = out["w"].numpy(), np.asarray(jout["w"])
    assert np.isfinite(got).all()
    if spec.startswith("clip"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    if spec == "trimmed_mean:0.25":
        honest = np.delete(delta, [3, 5, 7, 9], axis=0)
        assert got.min() >= honest.min() and got.max() <= honest.max()


def test_screen_quarantines_nonfinite_and_median_of_survivors():
    stacked = {"w": torch.tensor([[1., 1.], [float("nan"), 1.],
                                  [1., float("inf")], [2., 2.]])}
    out, keep = screen_and_defend(get_robust_aggregator("median"), stacked,
                                  {"w": torch.zeros(4, 2)})
    assert keep.tolist() == [1.0, 0.0, 0.0, 1.0]
    assert torch.allclose(out["w"], torch.full((4, 2), 1.5))


def test_krum_quarantines_outlier():
    honest = np.random.default_rng(0).normal(1.0, 0.05, (7, 4))
    delta = np.concatenate([honest[:3], [[-40.] * 4], honest[3:]]).astype(
        np.float32)
    out, keep = screen_and_defend(get_robust_aggregator("krum:0.2"),
                                  {"w": torch.from_numpy(delta)},
                                  {"w": torch.zeros(8, 4)})
    # multi-Krum quarantines f = round(0.2 * 8) = 2 rows, the planted
    # outlier among them; the deltas themselves are untouched
    assert keep[3] == 0.0 and keep.sum() == 6.0
    assert torch.equal(out["w"], torch.from_numpy(delta))
    _, jkeep = j_screen_and_defend(j_get_robust("krum:0.2"),
                                   {"w": jnp.asarray(delta)},
                                   {"w": jnp.zeros((8, 4))})
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def test_all_quarantined_keeps_zeroed_deltas():
    """Every row non-finite: the order statistics have no entry (NaN
    bounds), and the zeroed deltas pass through, as in the reference."""
    delta = np.full((4, 3), np.nan, np.float32)
    for spec in ("median", "trimmed_mean:0.25"):
        out, keep = screen_and_defend(
            get_robust_aggregator(spec), {"w": torch.from_numpy(delta)},
            {"w": torch.ones(4, 3)})
        jout, _ = j_screen_and_defend(
            j_get_robust(spec), {"w": jnp.asarray(delta)},
            {"w": jnp.ones((4, 3))})
        assert keep.sum() == 0
        np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))


def test_quarantine_reweight_preserves_mass():
    w = torch.tensor([[0.5, 0.3, 0.2], [0.2, 0.2, 0.6]])
    rw = quarantine_reweight(w, torch.tensor([1.0, 0.0, 1.0]))
    assert torch.allclose(rw[:, 1], torch.zeros(2))
    assert torch.allclose(rw.sum(1), w.sum(1))
    # all mass quarantined: fall back to the undefended row
    assert torch.equal(quarantine_reweight(w, torch.zeros(3)), w)


@pytest.mark.parametrize("spec", ["bitrot:1.0:0.3", "nan:0.5",
                                  "byz:0.5:scale:3", "byz:0.25:sign_flip",
                                  "bitrot:0.6:0.5,nan:0.3,byz:0.25"])
def test_inject_values_matches_reference_bitwise(spec):
    """The value faults on the same drawn bits (bit 31 included: the sign
    bit through INT_MIN, as XLA shifts it), with and without a rows mask,
    bitwise the reference's."""
    m, d = 8, 64
    rng = np.random.default_rng(3)
    prev = {"a": rng.standard_normal((m, 4, 4)).astype(np.float32),
            "b": rng.standard_normal((m, 48)).astype(np.float32)}
    stacked = {k: v + 0.01 * rng.standard_normal(v.shape).astype(np.float32)
               for k, v in prev.items()}
    plan, jplan = resolve_fault_plan(spec, m), j_resolve_fault_plan(spec, m)
    draws = ReplayDraws(SEED, 1)
    fd = draws.fault_draws(0, m, d, plan.cfg)
    if fd.bit is not None:
        assert int(fd.bit.max()) == 31
    kfault = jax.random.fold_in(draws.krounds[0], 3)
    for rows in (None, np.arange(m) % 3 != 0):
        want = j_inject_values(jplan, jnp.asarray(jplan.byz_row()),
                               stacked, prev, kfault,
                               rows=None if rows is None
                               else jnp.asarray(rows))
        got = inject_values(plan, torch.from_numpy(plan.byz_row()),
                            tree_from_numpy(stacked, "cpu"),
                            tree_from_numpy(prev, "cpu"), fd,
                            rows=None if rows is None
                            else torch.from_numpy(rows))
        for k in stacked:
            np.testing.assert_array_equal(
                got[k].numpy().view(np.int32),
                np.asarray(want[k]).view(np.int32), err_msg=k)


# ---------------------------------------------------------------------------
# the engine


def test_faults_off_parity(case):
    """faults=None, robust_agg="none", min_quorum=None and zero-rate specs
    are the clean engine, bitwise, fused and eventful."""
    for superstep in (None, False):
        h0 = run(case, superstep=superstep)
        h1 = run(case, superstep=superstep, faults=None, robust_agg="none",
                 min_quorum=None)
        h2 = run(case, superstep=superstep, faults="crash:0.0,byz:0,nan:0")
        for h in (h1, h2):
            _assert_same_run(h0, h)
        assert "faults" not in h1.extra


# the reference test's four faulted configurations, each on a strategy
# whose mix the quarantine reweights (the k-stream plan's centroids too)
FAULTED = [
    ("ucfl_k2", dict(faults="byz:0.25:sign_flip",
                     robust_agg="trimmed_mean:0.25"), False, None),
    ("fedavg", dict(faults="crash:0.3,nan:0.2", robust_agg="median"),
     False, None),
    ("ucfl", dict(faults="crash:0.5", min_quorum=6), False, None),
    ("ucfl_k2", dict(faults="bitrot:0.3,seed:2", robust_agg="krum:0.25"),
     True, "qsgd:8"),
]
IDS = ["byz_trimmed", "crash_nan_median", "crash_quorum",
       "sampler_qsgd8_bitrot_krum"]


def _faulted_kw(sampled, codec, j=False):
    kw = {}
    if sampled:
        kw["sampler"] = (JUniformFraction if j else UniformFraction)(0.5)
    if codec is not None:
        kw["channel"] = (JChannel if j else Channel)(codec=codec,
                                                     link="tiered:4")
    return kw


@pytest.mark.parametrize("spec,kw,sampled,codec", FAULTED, ids=IDS)
def test_fused_matches_eventful_with_faults(case, spec, kw, sampled, codec):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = run(case, spec, superstep=True, **kw,
                **_faulted_kw(sampled, codec))
        b = run(case, spec, superstep=False, **kw,
                **_faulted_kw(sampled, codec))
    _assert_same_run(a, b)
    assert a.extra["faults"]["rounds"] == FL_KW["rounds"]


@pytest.mark.parametrize("spec,kw,sampled,codec", FAULTED, ids=IDS)
def test_faults_match_reference_eventful(case, spec, kw, sampled, codec):
    """The reference's eventful run, the port's draws replaying its key
    chain and fault draws: clock, comm, comm bits and the fault ledger
    exact, accuracies within one argmax flip, params rtol 1e-4 / atol
    1e-5."""
    jfed, params0, fed = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_run(spec, jfed, fl=JFLConfig(**FL_KW),
                     model_init=lambda k: jlenet.init_params(k, NARROW),
                     system=J_SYSTEMS["wired"], superstep=False,
                     keep_state=True, seed=SEED, **kw,
                     **_faulted_kw(sampled, codec, j=True))
        got = run_federated(
            spec, fed, fl=FL,
            model_init=lambda gen: tree_from_numpy(params0, "cpu"),
            system=SYSTEMS["wired"], keep_state=True, seed=SEED,
            draws=ReplayDraws(SEED, FL_KW["rounds"], sampler_keys=sampled),
            device="cpu", **kw, **_faulted_kw(sampled, codec))
    assert got.rounds == want.rounds
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert [tuple(c) for c in got.comm_bits] == [tuple(c)
                                                for c in want.comm_bits]
    assert got.time == want.time
    assert got.extra["faults"] == want.extra["faults"]
    flip = 1.0 / (M * jfed.x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip + 1e-6)
    gp = tree_to_numpy(got.final_params)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_all_crash_keeps_init_params(case):
    h = run(case, faults="crash:1.0")
    assert h.extra["faults"]["crashed_total"] == M * FL_KW["rounds"]
    for k, v in case[1].items():
        # every round every row rolls back to prev; re-mixing identical
        # rows is an identity up to float reassociation
        np.testing.assert_allclose(h.final_params[k].numpy(),
                                   np.broadcast_to(v[None],
                                                   (M,) + v.shape),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_nan_warns_undefended_and_screened_defended(case):
    # argmax accuracy maps NaN logits to a finite score, so score by the
    # negative loss, which goes NaN when the aggregated params do
    def neg_loss(params, batch):
        return -lenet.loss_fn(params, batch)[0]

    with pytest.warns(NonFiniteEvalWarning):
        bad = run(case, faults="nan:1.0", acc_fn=neg_loss)
    assert bad.extra["nonfinite_evals"] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error", NonFiniteEvalWarning)
        ok = run(case, faults="nan:1.0", robust_agg="median",
                 acc_fn=neg_loss)
    assert np.isfinite(ok.mean_acc).all()
    assert ok.extra["faults"]["quarantined_total"] == M * FL_KW["rounds"]
    assert "nonfinite_evals" not in ok.extra


@pytest.mark.parametrize("superstep", [None, False], ids=["fused",
                                                          "eventful"])
def test_min_quorum_skips_rounds(case, superstep):
    h = run(case, faults="crash:1.0", min_quorum=1, superstep=superstep)
    assert h.extra["faults"]["skipped_rounds"] == FL_KW["rounds"]
    assert all(c.n_streams == 0 and c.n_unicasts == 0 for c in h.comm)
    ok = run(case, min_quorum=M, superstep=superstep)   # always met
    base = run(case, superstep=superstep)
    assert (ok.mean_acc, ok.time, ok.comm) == (base.mean_acc, base.time,
                                               base.comm)
    for k in base.final_params:
        assert torch.equal(ok.final_params[k], base.final_params[k]), k


def test_min_quorum_validation(case):
    with pytest.raises(ValueError, match="min_quorum"):
        run(case, min_quorum=0)


def test_pop_with_retries_backoff_ladder():
    """One fake clock and one always-crashing plan drive both packages'
    loops: the same requeue times, retries and dead clients."""
    class FakeClock:
        def __init__(self):
            self.heap = [(1.0, 5), (1.5, 2)]
            self.requeued = []

        def __len__(self):
            return len(self.heap)

        def pop(self):
            return self.heap.pop(0)

        def requeue(self, c, at):
            self.requeued.append((c, at))
            self.heap.append((at, c))

    class AlwaysCrash:
        cfg = type("C", (), {"crash": 1.0})()

        def arrival_crash(self):
            return True

    logs = []
    for pop, meter_cls in ((pop_with_retries, FaultMeter),
                           (j_pop_with_retries, JFaultMeter)):
        clock, meter = FakeClock(), meter_cls(None, "none", None)
        assert pop(clock, AlwaysCrash(), 2, 1.0, {}, meter) is None
        logs.append((clock.requeued, meter.retries, meter.dead))
    assert logs[0] == logs[1]
    assert logs[0][0][:2] == [(5, 2.0), (2, 2.5)]
    assert logs[0][1] == 4 and logs[0][2] == {2, 5}
    clock = FakeClock()
    assert pop_with_retries(clock, None, 2, 1.0, {}, None) == (1.0, 5)
    # both packages' real clocks and crash plans (numpy streams, the same
    # bits): the same pops, backoff requeues, retries and dead clients
    logs = []
    for clock_cls, system, plan_of, pop, meter_cls in (
            (VirtualClock, SYSTEMS["wireless_slow"], resolve_fault_plan,
             pop_with_retries, FaultMeter),
            (JVirtualClock, J_SYSTEMS["wireless_slow"], j_resolve_fault_plan,
             j_pop_with_retries, JFaultMeter)):
        clock, plan = clock_cls(system, seed=4), plan_of("crash:0.6", 6)
        meter, attempts, log = meter_cls(plan, "none", None), {}, []
        for c in range(6):
            clock.schedule(c, 0.0)
        while (nxt := pop(clock, plan, 1, 0.5, attempts, meter)) is not None:
            log.append((nxt, clock.now, len(clock)))
            clock.schedule(nxt[1], nxt[0] + 1.0)
        logs.append((log, meter.retries, meter.dead))
    assert logs[0] == logs[1]
    assert logs[0][1] > 0 and logs[0][2] == set(range(6))
