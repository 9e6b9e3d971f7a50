"""The port's buffered-async runtime against the reference, on the CPU.

Counterparts of tests/test_runtime.py's CPU cases: the virtual clock
(the same numpy draws, so the same pops and times, exactly), the
staleness factors and reweighting, the cohort update against the masked
full update (bitwise), the lockstep anchor (K = m, inv_mu = 0 is the
port's own synchronous run, bitwise), and buffered runs held against the
reference's: the port's draws replay the reference's key chain
(`ReplayDraws`, the event index standing for the round), so both runs
see the same minibatches, codec noise and fault draws.  History.time,
comm, comm_bits, ``extra["async"]`` and ``extra["faults"]`` must match
exactly, accuracies within one argmax flip (1/(m·n_val)), final params
within rtol 1e-4 / atol 1e-5 (tests/test_torch_engine.py's tolerances).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.federated import scenario_label_shift as j_label_shift
from repro.fl import AsyncConfig as JAsyncConfig
from repro.fl import Channel as JChannel
from repro.fl import FLConfig as JFLConfig
from repro.fl import MeshShardMap as JMeshShardMap
from repro.fl import SystemModel as JSystemModel
from repro.fl import VirtualClock as JVirtualClock
from repro.fl import run_federated as j_run
from repro.fl.channel import get_link_profile as j_link_profile
from repro.fl.strategies import STRATEGIES as J_STRATEGIES
from repro.fl.strategies.base import staleness_factors as j_factors
from repro.fl.strategies.base import staleness_reweight as j_reweight
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.data import scenario_label_shift
from repro_torch.fl import (AsyncConfig, Channel, FLConfig, HostVmap,
                            MeshShardMap, Placement, SystemModel, UniformFraction,
                            VirtualClock, run_async, run_federated)
from repro_torch.fl.channel.link import get_link_profile
from repro_torch.fl.strategies import (STRATEGIES, staleness_factors,
                                       staleness_reweight)
from repro_torch.models import lenet
from test_torch_engine import ReplayDraws

SEED = 0
M, N = 5, 400
FL_KW = dict(rounds=3, local_steps=2, batch_size=8, eval_every=1)
FL = FLConfig(**FL_KW)
NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
SYS = dict(rho=2.0, t_min=1.0, inv_mu=1.0, name="straggler")
STRAGGLER, J_STRAGGLER = SystemModel(**SYS), JSystemModel(**SYS)
RELIABLE = SystemModel(rho=2.0, t_min=1.0, inv_mu=0.0, name="reliable")


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
# virtual clock


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("with_link", [False, True])
def test_clock_matches_reference(seed, overlap, with_link):
    """Schedule, pop, requeue and serve in one interleaving on both
    clocks: every returned time, pop and ``now`` exactly equal."""
    m, bits = 6, 380_000
    link = jlink = None
    if with_link:
        link = get_link_profile("tiered:4", STRAGGLER, 1_521_472, m)
        jlink = j_link_profile("tiered:4", J_STRAGGLER, 1_521_472, m)
    clocks = (VirtualClock(STRAGGLER, seed=seed, link=link),
              JVirtualClock(J_STRAGGLER, seed=seed, link=jlink))
    logs = []
    for clock in clocks:
        log = [clock.schedule(i, 0.0, ul_bits=bits) for i in range(m)]
        for event in range(6):
            popped = [clock.pop() for _ in range(2)]
            done = clock.serve(1.0 + event % 3, overlap=overlap)
            log += [popped, clock.now, done, len(clock)]
            for _, c in popped:
                log.append(clock.schedule(c, done, ul_bits=bits))
            log.append(clock.requeue(popped[0][1], done + 0.25))
            log.append(clock.pop())
        logs.append(log)
    assert logs[0] == logs[1]


def test_clock_lockstep_pops_in_client_order():
    c = VirtualClock(RELIABLE, seed=0)
    for i in reversed(range(4)):
        c.schedule(i, 0.0)
    assert [c.pop() for _ in range(4)] == [(3.0, i) for i in range(4)]
    assert c.now == 3.0 and len(c) == 0
    assert c.serve(2.0) == 5.0 and c.serve(1.0) == 6.0   # queues
    assert c.serve(1.0, overlap=True) == 4.0            # concurrent carrier


def test_sample_compute_time_draws_once_when_random():
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    assert RELIABLE.sample_compute_time(rng_a) == 1.0
    assert rng_a.random() == rng_b.random()        # no draw taken
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    t = STRAGGLER.sample_client_time(rng_a)
    assert t == 1.0 + float(rng_b.exponential(1.0)) + 2.0
    assert rng_a.random() == rng_b.random()        # exactly one draw


# ---------------------------------------------------------------------------
# staleness reweighting

# f32 pow in torch and XLA may differ in the last bit; the renormalized
# matrix carries a few such roundings
POW_RTOL = 1e-6
W_CASES = {
    "stochastic": np.full((3, 5), 0.2, np.float32),
    "random": np.random.default_rng(0).random((4, 5)).astype(np.float32),
    "substochastic": np.asarray([[0.2, 0.3, 0.0, 0.1, 0.0]], np.float32),
    "zero_row": np.asarray([[0.0] * 5, [0.5, 0.5, 0.0, 0.0, 0.0]],
                           np.float32),
}
AGES = {"zero": [0, 0, 0, 0, 0], "mixed": [0, 1, 2, 5, 0],
        "old": [3, 7, 12, 1, 30]}


@pytest.mark.parametrize("schedule,kw", [("exp", dict(discount=0.8)),
                                         ("exp", dict(discount=1.0)),
                                         ("poly", dict(alpha=0.5)),
                                         ("poly", dict(alpha=2.0))])
@pytest.mark.parametrize("age", sorted(AGES))
def test_staleness_matches_reference(schedule, kw, age):
    a = np.asarray(AGES[age], np.float32)
    got = staleness_factors(torch.from_numpy(a), schedule=schedule, **kw)
    want = np.asarray(j_factors(jnp.asarray(a), schedule=schedule, **kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=POW_RTOL, atol=0)
    disc = kw.get("discount", 0.9)
    alpha = kw.get("alpha", 0.5)
    for name, w in W_CASES.items():
        got = staleness_reweight(torch.from_numpy(w), torch.from_numpy(a),
                                 disc, schedule=schedule, alpha=alpha)
        want = np.asarray(j_reweight(jnp.asarray(w), jnp.asarray(a), disc,
                                     schedule=schedule, alpha=alpha))
        np.testing.assert_allclose(got.numpy(), want, rtol=POW_RTOL,
                                   atol=1e-8, err_msg=name)
        np.testing.assert_allclose(got.numpy().sum(1), w.sum(1), rtol=1e-5)
        if age == "zero":                           # exact identity
            assert torch.equal(got, torch.from_numpy(w)), name
    with pytest.raises(ValueError, match="unknown staleness schedule"):
        staleness_factors(torch.zeros(2), schedule="nope")


# ---------------------------------------------------------------------------
# cohort update


def test_hostvmap_cohort_update_matches_masked_full_update(case):
    """HostVmap's gather / update / scatter equals the default run-every-
    row-and-mask path, bitwise, and leaves its inputs untouched."""
    _, params0, fed = case
    p = HostVmap()
    opt, update = p.build_update(lenet.loss_fn, FL)
    stacked = p.stack(tree_from_numpy(params0, "cpu"), M)
    stacked = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator()
                                         .manual_seed(1))
               for k, v in stacked.items()}
    opt_state = p.init_opt(opt, stacked)
    batch = ReplayDraws(3, 1).batch_indices(0, fed.n, fed.x.shape[1],
                                            FL.batch_size, FL.local_steps)
    before = {k: v.clone() for k, v in stacked.items()}
    for idx, keep in (([3, 0], [True, False]), ([4, 1, 2], [True] * 3),
                      ([2], [False])):
        args = (update, torch.tensor(idx), torch.tensor(keep), stacked,
                opt_state, fed.x, fed.y, fed.n, batch)
        fast = p.update_cohort(*args)
        slow = Placement.update_cohort(p, *args)
        for part in range(2):
            for k, v in slow[part].items():
                if v is None:
                    assert fast[part][k] is None
                    continue
                vs = v.values() if isinstance(v, dict) else [v]
                fs = (fast[part][k].values() if isinstance(v, dict)
                      else [fast[part][k]])
                for a, b in zip(fs, vs):
                    assert torch.equal(a, b), (idx, k)
        untouched = [i for i in range(M) if i not in
                     [c for c, kp in zip(idx, keep) if kp]]
        for k, v in fast[0].items():
            assert torch.equal(v[untouched], stacked[k][untouched])
    for k, v in stacked.items():
        assert torch.equal(v, before[k])


# ---------------------------------------------------------------------------
# lockstep anchor: inv_mu=0, K=m, no staleness bound == the sync engine


@pytest.mark.parametrize("spec", ["fedavg", "ucfl_k2", "cfl", "fedfomo"])
def test_async_lockstep_bit_identical_to_sync(spec, case):
    _, params0, fed = case
    kw = dict(fl=FLConfig(**FL_KW, cfl_min_rounds=1), system=RELIABLE,
              keep_state=True, device="cpu",
              model_init=lambda gen: tree_from_numpy(params0, "cpu"))
    sync = run_federated(spec, fed, draws=ReplayDraws(SEED, 3), **kw)
    a = run_federated(spec, fed, async_cfg=AsyncConfig(buffer_k=M),
                      draws=ReplayDraws(SEED, 3), **kw)
    assert a.mean_acc == sync.mean_acc and a.worst_acc == sync.worst_acc
    assert a.comm == sync.comm
    assert a.time == pytest.approx(sync.time)
    for k, v in sync.final_params.items():
        assert torch.equal(a.final_params[k], v), k
    assert a.extra["async"]["buffer_k"] == M


# ---------------------------------------------------------------------------
# buffered runs against the reference


class SpyVmap(HostVmap):
    """HostVmap recording each cohort update's (idx, keep)."""

    def __init__(self):
        self.cohorts = []

    def update_cohort(self, update_fn, idx, keep, *args):
        self.cohorts.append((idx.tolist(), keep.tolist()))
        return super().update_cohort(update_fn, idx, keep, *args)


BUFFERED = {
    "ucfl_k2-exp": ("ucfl_k2", dict(buffer_k=2, max_staleness=1,
                                    staleness_discount=0.8), {}),
    "fedfomo-poly": ("fedfomo", dict(buffer_k=2, max_staleness=1,
                                     staleness_schedule="poly",
                                     staleness_alpha=0.5), {}),
    "ucfl-qsgd4": ("ucfl", dict(buffer_k=3), dict(channel="qsgd:4")),
    "fedavg-crash": ("fedavg", dict(buffer_k=2, max_retries=1),
                     dict(faults="crash:0.5", min_quorum=2)),
    "fedavg-dead": ("fedavg", dict(buffer_k=2, max_retries=1),
                    dict(faults="crash:0.7", min_quorum=2)),
}


@pytest.fixture(scope="module")
def buffered_runs(case):
    """{name: (port History, reference History, SpyVmap, warnings)}."""
    jfed, params0, fed = case
    out = {}
    for name, (spec, acfg, kw) in BUFFERED.items():
        jkw = dict(kw)
        if "channel" in kw:
            jkw["channel"] = JChannel(codec=kw["channel"])
            kw = dict(kw, channel=Channel(codec=kw["channel"]))
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            # both packages start from the same params0 bits (the eager
            # and jitted inits differ in the conv weights' last bits)
            want = j_run(spec, jfed, fl=JFLConfig(**FL_KW),
                         model_init=lambda k: jax.tree_util.tree_map(
                             jnp.asarray, params0),
                         system=J_STRAGGLER, async_cfg=JAsyncConfig(**acfg),
                         keep_state=True, seed=SEED, **jkw)
        spy = SpyVmap()
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            got = run_federated(
                spec, fed, fl=FL,
                model_init=lambda gen: tree_from_numpy(params0, "cpu"),
                system=STRAGGLER, async_cfg=AsyncConfig(**acfg),
                keep_state=True, seed=SEED, placement=spy,
                draws=ReplayDraws(SEED, FL_KW["rounds"]), device="cpu",
                **kw)
        early = lambda ws: [str(w.message) for w in ws
                            if issubclass(w.category, RuntimeWarning)
                            and "ended early" in str(w.message)]
        out[name] = (got, want, spy, early(tw), early(jw))
    return out


@pytest.mark.parametrize("name", sorted(BUFFERED))
def test_buffered_run_matches_reference(name, buffered_runs, case):
    got, want, _, tw, jw = buffered_runs[name]
    assert tw == jw
    assert got.rounds == want.rounds
    assert got.time == want.time
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert ([tuple(c) for c in got.comm_bits]
            == [tuple(c) for c in want.comm_bits])
    assert got.extra["async"] == want.extra["async"]
    assert got.extra.get("faults") == want.extra.get("faults")
    assert got.extra.get("channel") == want.extra.get("channel")
    flip = 1.0 / (M * case[2].x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip + 1e-6)
    gp = tree_to_numpy(got.final_params)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("schedule,codec", [("gspmd", None),
                                            ("shard_map_streams", "qsgd:4")])
def test_async_on_the_mesh_matches_reference(schedule, codec, case):
    """`run_async` on the mesh placement (one rank; the base full-width
    cohort update, its mask cut to the rank's rows) against the
    reference's mesh async run (`test_runtime.py`'s `test_mesh_async_smoke`
    configuration, buffer_k 2 of 4) fed the same draws; and against the
    port's own `HostVmap` run (its row-gathered cohort update) at the same
    tolerances."""
    jfed, params0, fed = case
    acfg = dict(buffer_k=2, max_staleness=3.0, staleness_discount=0.8)
    want = j_run("ucfl_k2", jfed, fl=JFLConfig(**FL_KW),
                 model_init=lambda k: jax.tree_util.tree_map(jnp.asarray,
                                                             params0),
                 system=J_STRAGGLER, async_cfg=JAsyncConfig(**acfg),
                 keep_state=True, seed=SEED,
                 placement=JMeshShardMap(schedule=schedule),
                 channel=None if codec is None else JChannel(codec=codec))
    runs = [run_federated(
        "ucfl_k2", fed, fl=FL,
        model_init=lambda gen: tree_from_numpy(params0, "cpu"),
        system=STRAGGLER, async_cfg=AsyncConfig(**acfg), keep_state=True,
        seed=SEED, placement=placement,
        draws=ReplayDraws(SEED, FL_KW["rounds"]), device="cpu",
        channel=None if codec is None else Channel(codec=codec))
        for placement in (MeshShardMap(schedule=schedule, device="cpu"),
                          HostVmap())]
    flip = 1.0 / (M * fed.x_val.shape[1])
    for got in runs:
        assert got.time == want.time
        assert [tuple(c) for c in got.comm] == [tuple(c)
                                                for c in want.comm]
        np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                                   atol=flip + 1e-6)
        np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                                   atol=flip + 1e-6)
        gp = tree_to_numpy(got.final_params)
        for k, v in want.final_params.items():
            np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_buffered_runs_cover_drops_cohorts_and_early_end(buffered_runs):
    """Among the buffered runs: a stale update dropped at the last event
    (a cohort row not kept), partial cohorts updated by row gathers, and a
    crash run that skips an event below quorum, then ends early with the
    warning, in both packages."""
    for name in ("ucfl_k2-exp", "fedfomo-poly"):
        cohorts = buffered_runs[name][2].cohorts
        assert len(cohorts) == 3 and not all(cohorts[-1][1]), cohorts
    got, want, spy, tw, jw = buffered_runs["fedavg-dead"]
    assert tw and tw == jw and "ended early at event 2/3" in tw[0]
    assert got.rounds == [0, 1]
    ledger = got.extra["faults"]
    assert ledger["skipped_rounds"] == 1 and ledger["retries"] > 0
    assert ledger["dead_clients"] == list(range(M))
    assert buffered_runs["fedavg-crash"][0].extra["faults"]["dead_clients"]


# ---------------------------------------------------------------------------
# surface


def test_async_config_validation_and_entry_points():
    for kw, what in ((dict(buffer_k=0), "buffer_k"),
                     (dict(max_retries=-1), "max_retries"),
                     (dict(retry_backoff=0.0), "retry_backoff"),
                     (dict(staleness_schedule="lin"), "staleness_schedule"),
                     (dict(staleness_discount=0.0), "staleness_discount"),
                     (dict(staleness_alpha=-1.0), "staleness_alpha"),
                     (dict(max_staleness=-1.0), "max_staleness")):
        with pytest.raises(ValueError, match=what):
            AsyncConfig(**kw)
        with pytest.raises(ValueError, match=what):
            JAsyncConfig(**kw)
    fed = scenario_label_shift(0, n=100, m=2, device="cpu")
    cfg = AsyncConfig(buffer_k=2)
    with pytest.raises(TypeError, match="ClientSampler"):
        run_federated("fedavg", fed, async_cfg=cfg, device="cpu",
                      sampler=UniformFraction(0.5))
    with pytest.raises(TypeError, match="superstep"):
        run_federated("fedavg", fed, async_cfg=cfg, device="cpu",
                      superstep=True)
    with pytest.raises(TypeError, match="cannot resolve hierarchy"):
        run_async("fedavg", fed, async_cfg=cfg, device="cpu",
                  hierarchy=object())
    with pytest.raises(TypeError, match="cannot resolve hierarchy"):
        run_federated("fedavg", fed, async_cfg=cfg, device="cpu",
                      hierarchy=object())
    h = run_async("fedavg", fed, async_cfg=cfg, device="cpu", hierarchy=2,
                  fl=FLConfig(rounds=2, local_steps=1, batch_size=4,
                              eval_every=1))
    assert h.extra["hierarchy"]["d_max"] == 2
    assert len(h.extra["hierarchy"]["comm_bits"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_async("fedavg", fed, async_cfg=cfg)
    with pytest.raises(TypeError, match="fed"):
        run_async("fedavg", async_cfg=cfg, device="cpu")
    # superstep=None with async_cfg runs the event loop, unfused
    h = run_federated("fedavg", fed, async_cfg=cfg, device="cpu",
                      fl=FLConfig(rounds=2, local_steps=1, batch_size=4,
                                  eval_every=1))
    assert h.extra["async"]["events"] == 2 and len(h.comm) == 2


def test_reads_prev_declarations():
    for name in ("fedavg", "local", "oracle", "ucfl", "cfl", "fedfomo"):
        assert STRATEGIES[name].reads_prev == J_STRATEGIES[name].reads_prev
    assert not STRATEGIES["fedavg"].reads_prev
    assert not STRATEGIES["local"].reads_prev
    assert not STRATEGIES["oracle"].reads_prev
    assert not STRATEGIES["ucfl"].reads_prev
    assert STRATEGIES["cfl"].reads_prev
    assert STRATEGIES["fedfomo"].reads_prev
