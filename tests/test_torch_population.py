"""The port's cohort paging engine on the CPU, mirroring
tests/test_population.py on `HostVmap`.

The store and the schedules against the reference's (contents, bytes,
indices, ``spec`` and errors exactly); the paged synchronous engine
against the reference's `run_paged` (both packages from the same params0
bits, the port's draws replaying the reference's key chain through
`ReplayDraws`, which splits each round's key over the cohort's rows as
the reference's paged round does): rounds, clock, comm, comm_bits,
``extra["paging"]`` and the fault ledger exact, accuracies within one
argmax flip, final params within rtol 1e-4 / atol 1e-5
(tests/test_torch_superstep.py's tolerances).  Then the port's own
anchors: a paged `FixedCohort` run bitwise the resident fused run on the
sub-population, prefetch on bitwise off under overlapping cohorts, the
superstep cache untouched by a population doubling, the refusals,
`TorchDraws` resume bitwise (a corrupt newest snapshot falls back), a
population of 64x the cohort; and the paged async engine: the lockstep
anchor bitwise the port's `run_async`, a partial buffer against the
reference's `run_async_paged`, the k=3, n=8 arrival order.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.federated import scenario_label_shift as j_label_shift
from repro.fl import AsyncConfig as JAsyncConfig
from repro.fl import Channel as JChannel
from repro.fl import FixedCohort as JFixedCohort
from repro.fl import FLConfig as JFLConfig
from repro.fl import MeshShardMap as JMeshShardMap
from repro.fl import PagingConfig as JPagingConfig
from repro.fl import RandomCohorts as JRandomCohorts
from repro.fl import SequentialSweep as JSequentialSweep
from repro.fl import UniformFraction as JUniformFraction
from repro.fl import run_federated as j_run
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.fl.population import ClientStateStore as JStore
from repro.models import lenet as jlenet
from repro_torch.checkpoint import latest_paged_checkpoint
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.data import FederatedData, scenario_label_shift
from repro_torch.fl import (SYSTEMS, AsyncConfig, Channel, ClientStateStore,
                            FixedCohort, FLConfig, HostVmap, MeshShardMap,
                            PagingConfig,
                            RandomCohorts, SequentialSweep, TorchDraws,
                            UniformFraction, run_async, run_federated,
                            sub_federated)
from repro_torch.fl import simulator as sim
from repro_torch.fl.placement.graphs import leaves
from repro_torch.models import lenet
from test_torch_engine import ReplayDraws

SEED = 0
M, N = 8, 400
FL_KW = dict(rounds=5, local_steps=2, batch_size=8, eval_every=2)
FL = FLConfig(**FL_KW)
IDX = np.array([1, 3, 5, 7])
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


def _port_init(params0):
    return lambda gen: tree_from_numpy(params0, "cpu")


def _same_history(a, b):
    assert (a.rounds, a.mean_acc, a.worst_acc, a.time, a.comm,
            a.comm_bits) == (b.rounds, b.mean_acc, b.worst_acc, b.time,
                             b.comm, b.comm_bits)


def _same_tree(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _rows(tree, idx):
    return {k: v[torch.as_tensor(idx)] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the store


def _template():
    return {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": np.ones((4,), np.float32)},
            "opt": {"step": np.zeros((), np.int32), "mu": None}}


@pytest.mark.parametrize("backing", ["ram", "memmap"])
def test_store_roundtrip_matches_reference(backing, tmp_path):
    """Create, gather, scatter (numpy rows and tensors), flush and the
    state_dict round trip, step for step beside the reference's store:
    contents, nbytes and state_dict equal."""
    directory = None if backing == "ram" else str(tmp_path / "rows")
    jdir = None if backing == "ram" else str(tmp_path / "jrows")
    store = ClientStateStore.create(_template(), 16, directory=directory)
    jstore = JStore.create(_template(), 16, directory=jdir)
    idx = np.array([0, 5, 9])
    rows = store.gather(idx)
    np.testing.assert_array_equal(rows["params"]["w"][1],
                                  _template()["params"]["w"])
    new = {"params": {k: torch.from_numpy(v + 1.0)
                      for k, v in rows["params"].items()},
           "opt": {"step": rows["opt"]["step"] + 1, "mu": None}}
    store.scatter(idx, new)
    jstore.scatter(idx, {"params": {k: v + 1.0 for k, v in
                                    jstore.gather(idx)["params"].items()},
                         "opt": {"step": jstore.gather(idx)["opt"]["step"]
                                 + 1, "mu": None}})
    np.testing.assert_array_equal(store.gather(np.array([5]))["params"]["w"][0],
                                  _template()["params"]["w"] + 1.0)
    np.testing.assert_array_equal(store.gather(np.array([1]))["params"]["w"][0],
                                  _template()["params"]["w"])
    store.flush()
    assert store.nbytes == jstore.nbytes
    assert store.bytes_per_client == jstore.bytes_per_client
    sd, jsd = store.state_dict(), jstore.state_dict()
    assert sd["n"] == jsd["n"] == 16
    want = jax.tree_util.tree_leaves(jsd["tree"])
    assert len(leaves(sd["tree"])) == len(want)
    for a, b in zip(leaves(sd["tree"]), want):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    # a restored checkpoint's leaves are tensors: copied bitwise
    restored = {"n": 16, "tree": {"params": {k: torch.from_numpy(v.copy())
                                             for k, v in
                                             sd["tree"]["params"].items()},
                                  "opt": {"step": torch.from_numpy(
                                      sd["tree"]["opt"]["step"].copy()),
                                          "mu": None}}}
    clone = ClientStateStore.from_state_dict(
        restored, directory=None if directory is None else directory + "2")
    for a, b in zip(leaves(clone.tree), leaves(sd["tree"])):
        np.testing.assert_array_equal(a, b)
    if backing == "memmap":
        assert all(isinstance(a, np.memmap) for a in leaves(clone.tree))
        assert sorted(os.listdir(directory)) == sorted(
            os.listdir(directory + "2")) == [f"leaf_{i:04d}.npy"
                                             for i in range(3)]
    assert repr(store).startswith(f"ClientStateStore(n=16, {backing}")


def test_store_rejects_bad_leading_dim():
    for cls in (ClientStateStore, JStore):
        with pytest.raises(ValueError, match="leading dim 4, expected "
                                             "population size 8"):
            cls({"x": np.zeros((4, 2))}, 8)


# ---------------------------------------------------------------------------
# schedules


@pytest.mark.parametrize("make,n", [
    (lambda ns: ns["SequentialSweep"](4), 16),
    (lambda ns: ns["RandomCohorts"](4, seed=7), 32),
    (lambda ns: ns["RandomCohorts"](5), 11),
    (lambda ns: ns["FixedCohort"]([5, 1, 3]), 8)])
def test_schedules_match_reference(make, n):
    port = make(dict(SequentialSweep=SequentialSweep,
                     RandomCohorts=RandomCohorts, FixedCohort=FixedCohort))
    ref = make(dict(SequentialSweep=JSequentialSweep,
                    RandomCohorts=JRandomCohorts, FixedCohort=JFixedCohort))
    assert port.spec == ref.spec and port.cohort == ref.cohort
    assert repr(port) == repr(ref)
    for step in range(21):
        got, want = port.indices(step, n), ref.indices(step, n)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("call", [
    lambda ns: ns["SequentialSweep"](0),
    lambda ns: ns["SequentialSweep"](4).indices(0, 10),
    lambda ns: ns["RandomCohorts"](0),
    lambda ns: ns["RandomCohorts"](4).indices(0, 3),
    lambda ns: ns["FixedCohort"]([1, 1, 2]),
    lambda ns: ns["FixedCohort"]([]),
    lambda ns: ns["FixedCohort"]([9]).indices(0, 8),
    lambda ns: ns["PagingConfig"](cohort=0),
    lambda ns: ns["PagingConfig"](checkpoint_every=0),
    lambda ns: ns["PagingConfig"](schedule="nope").resolve_schedule()])
def test_schedule_validation_matches_reference(call):
    msgs = []
    for ns in (dict(SequentialSweep=SequentialSweep,
                    RandomCohorts=RandomCohorts, FixedCohort=FixedCohort,
                    PagingConfig=PagingConfig),
               dict(SequentialSweep=JSequentialSweep,
                    RandomCohorts=JRandomCohorts, FixedCohort=JFixedCohort,
                    PagingConfig=JPagingConfig)):
        with pytest.raises(ValueError) as e:
            call(ns)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the paged engine against the reference's run_paged

REF_SPECS = {
    "ucfl_k2-raw": ("ucfl_k2", {}),
    "ucfl_k2-qsgd4": ("ucfl_k2", dict(codec="qsgd:4")),
    "fedavg": ("fedavg", {}),
    "local": ("local", {}),
    "fedfomo": ("fedfomo", {}),
}
SCHEDULES = {"fixed": lambda: dict(schedule=FixedCohort(IDX)),
             "sweep": lambda: dict(cohort=4, schedule="sweep")}
J_SCHEDULES = {"fixed": lambda: dict(schedule=JFixedCohort(IDX)),
               "sweep": lambda: dict(cohort=4, schedule="sweep")}


def _against_reference(case, spec, schedule, system="wireless_slow",
                       codec=None, sampled=False, **kw):
    """(port History, reference History) of one paged configuration."""
    jfed, params0, fed = case
    jkw, pkw = dict(kw), dict(kw)
    if codec is not None:
        jkw["channel"], pkw["channel"] = (JChannel(codec=codec),
                                          Channel(codec=codec))
    if sampled:
        jkw["sampler"], pkw["sampler"] = (JUniformFraction(0.5),
                                          UniformFraction(0.5))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_run(spec, jfed, fl=JFLConfig(**FL_KW),
                     model_init=lambda k: jax.tree_util.tree_map(
                         jnp.asarray, params0),
                     system=J_SYSTEMS[system], keep_state=True, seed=SEED,
                     paging=JPagingConfig(**J_SCHEDULES[schedule]()), **jkw)
        got = run_federated(
            spec, fed, fl=FL, model_init=_port_init(params0),
            system=SYSTEMS[system], keep_state=True, seed=SEED,
            paging=PagingConfig(**SCHEDULES[schedule]()),
            draws=ReplayDraws(SEED, FL_KW["rounds"], sampler_keys=sampled),
            device="cpu", **pkw)
    return got, want


def _matches_reference(got, want, fed):
    assert got.rounds == want.rounds
    assert got.time == want.time
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert ([tuple(c) for c in got.comm_bits]
            == [tuple(c) for c in want.comm_bits])
    assert got.extra["paging"] == want.extra["paging"]
    assert got.extra.get("faults") == want.extra.get("faults")
    assert got.extra.get("channel") == want.extra.get("channel")
    flip = 1.0 / (IDX.size * fed.x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip + 1e-6)
    gp = tree_to_numpy(got.final_params)
    for k, v in want.final_params.items():
        assert gp[k].shape == np.asarray(v).shape == (M,) + v.shape[1:]
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(REF_SPECS))
def test_paged_matches_reference(name, schedule, case):
    spec, kw = REF_SPECS[name]
    got, want = _against_reference(case, spec, schedule, **kw)
    _matches_reference(got, want, case[2])
    assert got.extra["paging"]["chunks"] == 3


@pytest.mark.parametrize("name,kw", [
    ("sampler-qsgd4", dict(codec="qsgd:4", sampled=True)),
    ("crash-median-quorum", dict(faults="crash:0.3", robust_agg="median",
                                 min_quorum=3))])
def test_paged_sampler_and_faults_match_reference(name, kw, case):
    got, want = _against_reference(case, "ucfl_k2", "sweep", **kw)
    _matches_reference(got, want, case[2])
    if "faults" in kw:
        ledger = got.extra["faults"]
        assert ledger["crashed_total"] > 0 and ledger["skipped_rounds"] > 0


# ---------------------------------------------------------------------------
# the port's own anchors


@pytest.mark.parametrize("codec", [None, "qsgd:4"], ids=["raw", "qsgd4"])
def test_paged_mesh_matches_resident(codec, case):
    """The mesh placement (one rank) pages a cohort through its `stage`
    and gathered copy back: a paged `FixedCohort` run is bitwise the
    resident mesh run on the sub-population and the paged `HostVmap`
    run (the reference's `test_paged_matches_resident`, mesh half)."""
    _, params0, fed = case
    common = dict(fl=FL, model_init=_port_init(params0), keep_state=True,
                  system=SYSTEMS["wired"], device="cpu",
                  channel=None if codec is None else Channel(codec=codec))
    mesh = lambda: MeshShardMap(schedule="shard_map_streams", device="cpu")
    res = run_federated("ucfl_k2", sub_federated(fed, IDX), superstep=True,
                        placement=mesh(), **common)
    pag = run_federated("ucfl_k2", fed, placement=mesh(),
                        paging=PagingConfig(schedule=FixedCohort(IDX)),
                        **common)
    host = run_federated("ucfl_k2", fed, placement=HostVmap(),
                         paging=PagingConfig(schedule=FixedCohort(IDX)),
                         **common)
    _same_history(pag, res)
    _same_tree(_rows(pag.final_params, IDX), res.final_params)
    _same_history(pag, host)
    _same_tree(pag.final_params, host.final_params)


def test_paged_mesh_matches_reference(case):
    """Paged ucfl_k2 + qsgd:4 over the sweep on the mesh placement against
    the reference's paged mesh run, fed the same draws."""
    jfed, params0, fed = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_run("ucfl_k2", jfed, fl=JFLConfig(**FL_KW),
                     model_init=lambda k: jax.tree_util.tree_map(
                         jnp.asarray, params0),
                     system=J_SYSTEMS["wireless_slow"], keep_state=True,
                     seed=SEED, channel=JChannel(codec="qsgd:4"),
                     placement=JMeshShardMap(schedule="shard_map_streams"),
                     paging=JPagingConfig(**J_SCHEDULES["sweep"]()))
    got = run_federated(
        "ucfl_k2", fed, fl=FL, model_init=_port_init(params0),
        system=SYSTEMS["wireless_slow"], keep_state=True, seed=SEED,
        channel=Channel(codec="qsgd:4"),
        placement=MeshShardMap(schedule="shard_map_streams", device="cpu"),
        paging=PagingConfig(**SCHEDULES["sweep"]()),
        draws=ReplayDraws(SEED, FL_KW["rounds"]), device="cpu")
    _matches_reference(got, want, fed)


def test_async_paged_mesh_is_the_host_run(case):
    """`run_async_paged` on the mesh placement (one rank) is bitwise the
    `HostVmap` paged async run, at a partial buffer (K = 3 of 8)."""
    _, params0, fed = case
    runs = [run_federated(
        "ucfl_k2", fed, fl=FL, model_init=_port_init(params0),
        system=SYSTEMS["wireless_slow"], keep_state=True, device="cpu",
        async_cfg=AsyncConfig(buffer_k=3), placement=placement,
        paging=PagingConfig(schedule=FixedCohort(np.arange(M))))
        for placement in (MeshShardMap(device="cpu"), HostVmap())]
    _same_history(*runs)
    _same_tree(*(r.final_params for r in runs))


@pytest.mark.parametrize("spec,kw", [
    ("ucfl_k2", {}), ("ucfl_k2", dict(channel="qsgd:4")),
    ("ucfl_k2", dict(channel="qsgd:4", sampler=UniformFraction(0.5))),
    ("fedfomo", {}),
    ("fedavg", dict(faults="crash:0.3", robust_agg="median",
                    min_quorum=3))])
def test_paged_fixed_cohort_is_resident_on_the_subpopulation(spec, kw, case):
    """A paged `FixedCohort` run replays the resident fused run on the
    sub-population bitwise (same seed, same default draws, same cached
    superstep)."""
    _, params0, fed = case
    if "channel" in kw:
        kw = dict(kw, channel=Channel(codec=kw["channel"]))
    common = dict(fl=FL, model_init=_port_init(params0), keep_state=True,
                  system=SYSTEMS["wireless_slow"], device="cpu", **kw)
    res = run_federated(spec, sub_federated(fed, IDX), superstep=True,
                        **common)
    pag = run_federated(spec, fed,
                        paging=PagingConfig(schedule=FixedCohort(IDX)),
                        **common)
    _same_history(pag, res)
    assert pag.extra.get("faults") == res.extra.get("faults")
    _same_tree(_rows(pag.final_params, IDX), res.final_params)
    _same_tree({k: _rows(v, IDX) if isinstance(v, dict) else
                v[torch.as_tensor(IDX)]
                for k, v in pag.final_opt_state.items() if v is not None},
               {k: v for k, v in res.final_opt_state.items()
                if v is not None})
    if "channel" in kw:
        _same_tree(_rows(pag.final_residual, IDX), res.final_residual)
    rest = np.setdiff1d(np.arange(M), IDX)      # untouched rows: params0
    for k, v in pag.final_params.items():
        want = torch.tensor(params0[k])[None].expand(rest.size,
                                                     *v.shape[1:])
        assert torch.equal(v[torch.as_tensor(rest)], want)
    assert pag.extra["paging"]["population"] == M


@pytest.mark.parametrize("schedule", ["random", "sweep"])
def test_prefetch_on_equals_off(schedule, case):
    """The double buffer changes no bit: prefetch on and off give the same
    history and store rows, with consecutive random cohorts overlapping
    (the drain-before-gather path) and with a disjoint sweep."""
    _, params0, fed = case
    sched = RandomCohorts(6, seed=3) if schedule == "random" else "sweep"
    if schedule == "random":
        cohorts = [sched.indices(t, M) for t in range(3)]
        assert all(np.intersect1d(a, b).size
                   for a, b in zip(cohorts, cohorts[1:]))
    hs = []
    for prefetch in (True, False):
        hs.append(run_federated(
            "ucfl_k2", fed, fl=FL, model_init=_port_init(params0),
            channel=Channel(codec="qsgd:4"), system=SYSTEMS["wireless_slow"],
            keep_state=True, device="cpu",
            paging=PagingConfig(cohort=4, schedule=sched,
                                prefetch=prefetch)))
    _same_history(*hs)
    for part in ("final_params", "final_opt_state", "final_residual"):
        _same_tree(getattr(hs[0], part), getattr(hs[1], part))


def test_superstep_cache_reused_across_population_sizes(case):
    """The chunks are keyed on the cohort's shapes: a paged run over a
    doubled population adds no cache entry and no chunk beside a resident
    run of the cohort's size."""
    _, params0, fed = case
    kw = dict(fl=FL, model_init=_port_init(params0), device="cpu")
    run_federated("ucfl_k2", fed, **kw)
    before = {k: dict(v) for k, v in sim._SUPERSTEP_FNS.items()}
    fed2 = FederatedData(*(torch.cat([t, t]) for t in fed))
    run_federated("ucfl_k2", fed2,
                  paging=PagingConfig(schedule=FixedCohort(np.arange(M))),
                  **kw)
    assert set(sim._SUPERSTEP_FNS) == set(before), \
        "population size leaked into the superstep cache key"
    for key, chunks in sim._SUPERSTEP_FNS.items():
        assert chunks.keys() == before[key].keys()
        assert all(chunks[k] is fn for k, fn in before[key].items())


def test_paged_refusals(case):
    _, _, fed = case
    pg = PagingConfig(cohort=4)
    with pytest.raises(ValueError, match="cannot fuse"):
        run_federated("cfl", fed, fl=FL, paging=pg, device="cpu")
    with pytest.raises(TypeError, match="superstep=False"):
        run_federated("fedavg", fed, fl=FL, superstep=False, paging=pg,
                      device="cpu")
    with pytest.raises(ValueError, match="cohort 16 > population 8"):
        run_federated("fedavg", fed, fl=FL, paging=PagingConfig(cohort=16),
                      device="cpu")
    for kw in (dict(), dict(async_cfg=AsyncConfig(buffer_k=2))):
        with pytest.raises(TypeError, match="hierarchy tier does not "
                                            "compose"):
            run_federated("fedavg", fed, fl=FL, paging=pg, hierarchy=2,
                          device="cpu", **kw)
        h = run_federated("fedavg", fed, fl=FL, hierarchy=2, device="cpu",
                          **kw)
        assert h.extra["hierarchy"]["d_max"] == 2
        with pytest.raises(TypeError, match="cannot resolve hierarchy"):
            run_federated("fedavg", fed, fl=FL, hierarchy=object(),
                          device="cpu", **kw)
    with pytest.raises(TypeError, match="hierarchy tier does not compose"):
        run_async("fedavg", fed, fl=FL, paging=pg, hierarchy=2, device="cpu")
    if not torch.cuda.is_available():       # the card is the default device
        with pytest.raises(RuntimeError, match="cuda"):
            run_federated("fedavg", fed, fl=FL, paging=pg)


def _resume_kw(case, tmp_path, **paging):
    _, params0, fed = case
    base = dict(cohort=4, schedule="sweep",
                checkpoint_dir=str(tmp_path / "ck"),
                store_dir=str(tmp_path / "store"), **paging)
    return dict(fl=dataclasses.replace(FL, rounds=7, eval_every=1),
                model_init=_port_init(params0), keep_state=True,
                channel=Channel(codec="qsgd:4"), device="cpu",
                system=SYSTEMS["wireless_slow"]), base


def test_paged_resume_mid_sweep_is_bitwise(case, tmp_path):
    """Preempted after 3 of 7 supersteps and resumed from the memmap
    store's snapshot with `TorchDraws`: the finished run equals the
    uninterrupted one bitwise (the draws' state is taken right after each
    chunk's own draws).  Then a flipped byte in the newest snapshot: the
    resume warns, falls back to the one before and still ends bitwise."""
    _, _, fed = case
    kw, base = _resume_kw(case, tmp_path)
    full = run_federated("ucfl_k2", fed, paging=PagingConfig(
        cohort=4, schedule="sweep"), **kw)
    part = run_federated("ucfl_k2", fed,
                         paging=PagingConfig(max_chunks=3, **base), **kw)
    assert part.rounds == full.rounds[:3]
    assert part.mean_acc == full.mean_acc[:3]
    path = latest_paged_checkpoint(base["checkpoint_dir"])
    assert path.endswith("superstep_000002.msgpack")
    res = run_federated("ucfl_k2", fed,
                        paging=PagingConfig(resume=True, **base), **kw)
    _same_history(res, full)
    for part_name in ("final_params", "final_opt_state", "final_residual"):
        _same_tree(getattr(res, part_name), getattr(full, part_name))
    assert res.extra["paging"]["resumed_at"] == 3
    assert res.extra["paging"]["store_dir"] == base["store_dir"]

    # corrupt the newest snapshot of a run preempted at 4 supersteps
    for f in os.listdir(base["checkpoint_dir"]):
        os.remove(os.path.join(base["checkpoint_dir"], f))
    run_federated("ucfl_k2", fed, paging=PagingConfig(max_chunks=4, **base),
                  **kw)
    newest = latest_paged_checkpoint(base["checkpoint_dir"])
    assert newest.endswith("superstep_000003.msgpack")
    blob = bytearray(open(newest, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(blob))
    with pytest.warns(RuntimeWarning, match="failed its integrity check"):
        res = run_federated("ucfl_k2", fed,
                            paging=PagingConfig(resume=True, **base), **kw)
    assert res.extra["paging"]["resumed_at"] == 3
    _same_history(res, full)
    _same_tree(res.final_params, full.final_params)


def test_paged_resume_rejects_mismatched_config(case, tmp_path):
    _, params0, fed = case
    ck = str(tmp_path / "ck")
    kw = dict(fl=FL, model_init=_port_init(params0), device="cpu")
    run_federated("fedavg", fed, paging=PagingConfig(
        cohort=4, checkpoint_dir=ck, max_chunks=1), **kw)
    with pytest.raises(ValueError, match="different run configuration"):
        run_federated("fedavg", fed, seed=1, paging=PagingConfig(
            cohort=4, checkpoint_dir=ck, resume=True), **kw)


def test_paged_population_64x_cohort():
    fed = scenario_label_shift(1, n=1600, m=128, device="cpu")
    h = run_federated("fedavg", fed, keep_state=True, device="cpu",
                      fl=FLConfig(rounds=2, local_steps=1, batch_size=8,
                                  eval_every=1),
                      model_init=lambda gen: lenet.init_params(
                          gen, lenet.LeNetConfig(c1=2, c2=4, fc1=16,
                                                 fc2=12), device="cpu"),
                      paging=PagingConfig(cohort=2, schedule="sweep"))
    pg = h.extra["paging"]
    assert pg["population"] == 128 and pg["cohort"] == 2
    assert pg["population"] >= 64 * pg["cohort"]
    assert len(h.mean_acc) == 2 and np.isfinite(h.mean_acc).all()
    for leaf in h.final_params.values():
        assert leaf.shape[0] == 128 and torch.isfinite(leaf).all()


# ---------------------------------------------------------------------------
# the paged buffered-async engine


@pytest.mark.parametrize("spec,kw", [("fedavg", {}),
                                     ("ucfl_k2", dict(channel="qsgd:4"))])
def test_async_paged_lockstep_is_resident(spec, kw, case):
    """buffer_k == population on the reliable system: every event is a
    lockstep round, and the store-backed loop is bitwise the resident
    `run_async`."""
    _, params0, fed = case
    if "channel" in kw:
        kw = dict(channel=Channel(codec=kw["channel"]))
    common = dict(async_cfg=AsyncConfig(buffer_k=M), fl=FL,
                  model_init=_port_init(params0), keep_state=True,
                  device="cpu", **kw)
    res = run_async(spec, fed, **common)
    pag = run_async(spec, fed, paging=PagingConfig(cohort=M), **common)
    _same_history(pag, res)
    _same_tree(pag.final_params, res.final_params)
    _same_tree(pag.final_opt_state, res.final_opt_state)
    assert pag.extra["async"] == res.extra["async"]
    assert pag.extra["paging"]["schedule"] == "arrival-buffer"
    assert pag.extra["paging"]["cohort"] == M


def test_async_paged_partial_buffer_matches_reference(case):
    """K = 4 of 8 over wireless_fast, ucfl_k2: the cohort-local mix, its
    clock and comm exactly the reference's `run_async_paged`, params at
    tolerance."""
    jfed, params0, fed = case
    want = j_run("ucfl_k2", jfed, fl=JFLConfig(**FL_KW),
                 model_init=lambda k: jax.tree_util.tree_map(jnp.asarray,
                                                             params0),
                 system=J_SYSTEMS["wireless_fast"],
                 async_cfg=JAsyncConfig(buffer_k=4),
                 paging=JPagingConfig(cohort=4), keep_state=True, seed=SEED)
    got = run_federated("ucfl_k2", fed, fl=FL, model_init=_port_init(params0),
                        system=SYSTEMS["wireless_fast"],
                        async_cfg=AsyncConfig(buffer_k=4),
                        paging=PagingConfig(cohort=4), keep_state=True,
                        seed=SEED, draws=ReplayDraws(SEED, FL_KW["rounds"]),
                        device="cpu")
    assert got.rounds == want.rounds and len(got.rounds) >= 1
    assert got.time == want.time
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert got.extra["async"] == want.extra["async"]
    assert got.extra["paging"] == want.extra["paging"]
    flip = 1.0 / (4 * fed.x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    gp = tree_to_numpy(got.final_params)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        assert np.isfinite(gp[k]).all()


def test_async_paged_partial_buffer_arrival_order(case):
    """``buffer_k`` not dividing the population (k=3, n=8) on the
    deterministic wired clock: the paged loop reports the resident async
    engine's times and comm, and both follow a reference heap (the wrap
    events mix first- and second-generation arrivals)."""
    import heapq
    _, params0, fed = case
    k, n = 3, M
    fl = FLConfig(rounds=6, local_steps=1, batch_size=8, eval_every=1)
    kw = dict(async_cfg=AsyncConfig(buffer_k=k), fl=fl,
              model_init=_port_init(params0), system=SYSTEMS["wired"],
              device="cpu")
    h_pag = run_async("fedavg", fed, paging=PagingConfig(cohort=k), **kw)
    h_res = run_async("fedavg", fed, **kw)
    assert h_pag.time == h_res.time
    assert h_pag.comm == h_res.comm
    assert h_pag.rounds == h_res.rounds

    sysm = SYSTEMS["wired"]
    assert sysm.inv_mu == 0.0
    step = sysm.t_min + sysm.rho
    heap = [(step, c) for c in range(n)]
    heapq.heapify(heap)
    expect_time, cohorts, now, t_done = [], [], 0.0, 0.0
    for _ in range(fl.rounds):
        cohort = []
        for _ in range(k):
            t, c = heapq.heappop(heap)
            now = max(now, t)
            cohort.append(c)
        done = now + 1                   # fedavg: one broadcast stream
        t_done = max(t_done, done)
        for c in cohort:
            heapq.heappush(heap, (done + step, c))
        cohorts.append(cohort)
        expect_time.append(t_done)
    assert h_pag.time == expect_time
    assert cohorts[2] == [6, 7, 0]


def test_torch_draws_state_roundtrip():
    """`TorchDraws.state_dict` / `load_state_dict` put every stream back."""
    n = torch.full((3,), 20.0)
    a = TorchDraws(5, "cpu")
    a.batch_indices(0, n, 20, 4, 2)
    a.permutation(0, 6)
    state = a.state_dict()
    want = (a.batch_indices(1, n, 20, 4, 2), a.permutation(1, 6),
            a.codec_noise(1, (3, 7)))
    b = TorchDraws(9, "cpu")
    b.load_state_dict(state)
    got = (b.batch_indices(1, n, 20, 4, 2), b.permutation(1, 6),
           b.codec_noise(1, (3, 7)))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


_CYCLES = """
import gc
import torch
torch.set_num_threads(1)
from repro_torch.data import scenario_label_shift
from repro_torch.fl import (SYSTEMS, Channel, FLConfig, PagingConfig,
                            run_federated)
fed = scenario_label_shift(0, n=24 * 50, m=24, device="cpu")
gc.collect()
gc.disable()
gc.set_debug(gc.DEBUG_SAVEALL)
h = run_federated("ucfl_k4", fed, keep_state=True,
                  paging=PagingConfig(cohort=8),
                  fl=FLConfig(rounds=2, local_steps=1, batch_size=8,
                              eval_every=1),
                  system=SYSTEMS["wireless_slow"],
                  channel=Channel(codec="qsgd:8"), seed=0, device="cpu")
assert h.final_params is not None and h.final_residual is not None
del h
gc.collect()
print(sum(isinstance(o, torch.Tensor) for o in gc.garbage))
"""


def test_paged_keep_state_leaves_no_tensor_in_cycles():
    """The first paged ``keep_state`` run of a fresh process (population
    24, cohorts of 8, 2 rounds, the collector off) leaves no tensor for
    the cycle collector.  torch.func's first gradient would import
    torch._dynamo, and that import keeps its caller's frames (the run's
    data pages among their locals) alive; `repro_torch` imports it
    first."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _CYCLES], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src"),
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0"]
