"""The mesh placement against the reference's `MeshShardMap`, on the CPU.

`repro_torch.fl.MeshShardMap` runs one process per rank over a gloo
group; the reference is one controller over a device mesh.  Here:

* `mix_schedule` for each schedule x {full W, plan}: at one rank (an
  in-process gloo group) bitwise the port's host mix and within rtol
  1e-6 / atol 1e-7 of the reference's `mix_schedule`; at 2 and 4 ranks
  within rtol 1e-6 / atol 1e-7 of the reference, on random f32 stacks;
* `run_federated` for fedavg, ucfl_k2 and local x the three schedules
  (the counterpart of `test_mesh_matches_host`): at one rank at
  `test_torch_engine`'s tolerances against the reference's mesh run; at
  2 and 4 ranks the accuracies within the reference's atol 2e-2 and
  `History.comm` equal.  The port replays the reference's key chain
  through a recorded tape (`TapeDraws`): every rank draws every draw in
  full, so the tape of the single-process run must replay unchanged;
* at 2 and 4 ranks, the other engines and layers (`JOBS`): the eventful
  engine with a sampler and qsgd:4, a faulted run, async K = 2 of 4, a
  paged and a paged async run, a two-level qsgd:4 hierarchy run, each
  against the reference's one-device mesh run (rounds, comm, comm bits,
  clock and extras equal, accuracies within atol 2e-2, params at
  `test_torch_engine`'s tolerances, with qsgd's level flips allowed as
  in `test_torch_hierarchy`); served batches on a qsgd:4 store file
  against the reference's mesh `ServeEngine` at atol 1e-5; and the paged
  async engine on cohorts of 3, which leave ranks without rows (at the
  first event and mid-run), against the reference's run;
* every registered strategy on the mesh (gspmd) at 4 ranks;
* the errors (a group that does not divide m, an unknown schedule), one
  placement reused across m = 20 then 5 on 4 ranks (the auto group shrinks
  to 1 rank and the idle ranks receive rank 0's History), and the auto
  group size;
* the reference itself at 4 host devices, in a subprocess, against the
  port at 4 ranks.

The several-rank runs are spawned once per world size by a module-scoped
fixture (this file run as ``python tests/test_torch_mesh.py --worker``,
which imports no JAX), beside the reference's runs of the jobs (``...
--reference``), and every case reads their results.
"""
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SCHEDULES = ("gspmd", "shard_map_streams", "shard_map_unicast")
ALL_SPECS = ("fedavg", "local", "oracle", "ucfl", "ucfl_k2", "cfl",
             "fedfomo")
MIX_M, MIX_K = 8, 3
FL_KW = dict(rounds=3, local_steps=2, batch_size=8, eval_every=1)
RUN_SPECS = ("fedavg", "ucfl_k2", "local")
# the other engines and layers on the mesh, each with the schedule it runs
# (ucfl_k2, `FL_KW`, wireless_slow); "paged" and "apaged" page a
# population of 8 in cohorts of 4
JOBS = {"channel": "shard_map_streams", "faults": "gspmd",
        "async": "shard_map_streams", "paged": "shard_map_unicast",
        "apaged": "gspmd", "hier": "shard_map_streams"}
M8 = 8
# the paged async engine on cohorts that leave ranks without rows: K = 3
# of 8 at every event, and K = 4 whose arrivals fall to 3 mid-run
# (crashes without retries: events of 4, then 3, then the run ends)
UNEVEN = {"apaged3": "gspmd", "apaged_crash": "shard_map_streams"}
ALL_JOBS = {**JOBS, **UNEVEN}
# the reference's runs of the jobs, split over two processes of about
# the same time
REF_PARTS = {"a": ("channel", "async", "apaged", "apaged3"),
             "b": ("paged", "faults", "hier", "apaged_crash")}
TWO_LEVEL = dict(devices_per_user="ragged:2-4", edge_codec="qsgd:4",
                 edge_link="tiered:4", edge_latency=0.5)
SERVE_USERS = ([1, 3, 0, 2, 2, 0, 3, 1], [2, 0, 1, 3, 0, 2])


def _job_kwargs(name, fl, ref=False):
    """The run arguments of job ``name`` beyond its scenario, from the
    package module ``fl`` (`repro_torch.fl` or the reference's
    `repro.fl`); the reference runs its eventful engine where the port's
    test files hold it so."""
    if name == "channel":       # a sampler and qsgd:4, the eventful engine
        return dict(sampler=fl.UniformFraction(0.5), superstep=False,
                    channel=fl.Channel(codec="qsgd:4", link="tiered:4"))
    if name == "faults":        # a Byzantine row, crashes, NaN rows
        return dict(faults="byz:0.25:sign_flip,crash:0.25,nan:0.25",
                    robust_agg="trimmed_mean:0.25", superstep=False)
    if name == "async":         # K = 2 of 4, the full-width cohort update
        return dict(async_cfg=fl.AsyncConfig(buffer_k=2, max_staleness=3.0,
                                             staleness_discount=0.8),
                    channel=fl.Channel(codec="qsgd:4"))
    if name == "paged":
        return dict(channel=fl.Channel(codec="qsgd:4"),
                    paging=fl.PagingConfig(cohort=4, schedule="sweep"))
    if name == "apaged":
        return dict(async_cfg=fl.AsyncConfig(buffer_k=4),
                    paging=fl.PagingConfig(cohort=4))
    if name == "apaged3":
        return dict(async_cfg=fl.AsyncConfig(buffer_k=3),
                    paging=fl.PagingConfig(cohort=3))
    if name == "apaged_crash":
        return dict(async_cfg=fl.AsyncConfig(buffer_k=4, max_retries=0),
                    paging=fl.PagingConfig(cohort=4), faults="crash:0.5")
    assert name == "hier"       # two-level, a qsgd:4 edge codec
    return dict(hierarchy=fl.HierarchyConfig(**TWO_LEVEL),
                **(dict(superstep=False) if ref else {}))


def _port_job(name, feds, params0, placement, draws):
    import repro_torch.fl as fl
    from repro_torch.convert import tree_from_numpy
    return fl.run_federated(
        "ucfl_k2", feds[M8 if "paged" in name else 4],
        fl=fl.FLConfig(**FL_KW),
        model_init=lambda gen: tree_from_numpy(params0, "cpu"),
        system=fl.SYSTEMS["wireless_slow"], keep_state=True, seed=0,
        draws=draws, placement=placement, device="cpu",
        **_job_kwargs(name, fl))


def apply_one(params, x):
    from repro_torch.models import lenet
    return lenet.apply(params, x[None])[0]


class TapeDraws:
    """Replays the draws a single-process run recorded (``record``), call
    by call: a mesh rank must ask for the same draws in the same order."""

    def __init__(self, inner=None, tape=None):
        self.inner, self.tape, self.at = inner, ([] if tape is None
                                                 else tape), 0

    def _call(self, name, *args):
        if self.inner is not None:
            out = getattr(self.inner, name)(*args)
            self.tape.append((name, args[0] if args else None, out))
            return out
        want, rnd, out = self.tape[self.at]
        got = args[0] if args else None
        assert (want, rnd) == (name, got), (
            f"draw {self.at}: asked {name}({got}), the tape has "
            f"{want}({rnd})")
        self.at += 1
        return out

    def __getattr__(self, name):
        if name in ("batch_indices", "kmeans_first", "permutation",
                    "codec_noise", "fault_draws", "device_batch_indices",
                    "edge_noise", "device_dropout"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


def _mix_inputs(seed=0):
    rng = np.random.default_rng(seed)
    stack = {"a": rng.standard_normal((MIX_M, 3, 5)).astype(np.float32),
             "b": rng.standard_normal((MIX_M, 7)).astype(np.float32)}
    w = rng.random((MIX_M, MIX_M)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    cen = rng.random((MIX_K, MIX_M)).astype(np.float32)
    cen /= cen.sum(1, keepdims=True)
    asn = rng.integers(0, MIX_K, MIX_M).astype(np.int32)
    return stack, w, cen, asn


def _history(h):
    return {"rounds": list(h.rounds), "mean_acc": list(h.mean_acc),
            "worst_acc": list(h.worst_acc), "time": list(h.time),
            "comm": [tuple(c) for c in h.comm],
            "comm_bits": [tuple(c) for c in h.comm_bits],
            "extra": {k: h.extra.get(k) for k in ("async", "paging",
                                                   "faults")},
            "hier": _hier_books(h),
            "params": None if h.final_params is None else
            {k: np.asarray(v) for k, v in h.final_params.items()}}


def _hier_books(h):
    ex = h.extra.get("hierarchy")
    if ex is None:
        return None
    return dict(ex, comm_bits=[tuple(c) for c in ex["comm_bits"]])


def _worker(rank, world, port, path, out_path):
    """One rank: runs every job of the pickled input, writes its results
    to ``out_path``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from repro_torch.convert import fed_from_numpy, tree_from_numpy
    from repro_torch.core.distributed import mix_schedule
    from repro_torch.data import scenario_label_shift
    from repro_torch.fl import FLConfig, MeshShardMap, SYSTEMS, run_federated
    from repro_torch.models import lenet
    with open(path, "rb") as f:
        inp = pickle.load(f)
    fed = fed_from_numpy(*inp["fed"], device="cpu")
    feds = {4: fed, M8: fed_from_numpy(*inp["fed8"], device="cpu")}
    p0 = inp["params0"]
    fl = FLConfig(**FL_KW)
    init = lambda gen: tree_from_numpy(p0, "cpu")
    out = {}

    def mesh(schedule="gspmd", group=None):
        return MeshShardMap(group, schedule=schedule, device="cpu")

    # the schedules, each rank with its rows of the stack
    stack, w, cen, asn = inp["mix"]
    mm = MIX_M // world
    mine = {k: torch.from_numpy(v[rank * mm:(rank + 1) * mm])
            for k, v in stack.items()}
    from repro_torch.core.distributed import gather_tree
    for sched in SCHEDULES:
        full = mix_schedule(None, mine, torch.from_numpy(w), schedule=sched)
        plan = mix_schedule(None, mine, torch.from_numpy(cen),
                            torch.from_numpy(asn), schedule=sched)
        out[("mix", sched, "full")] = {
            k: v.numpy() for k, v in gather_tree(full, None).items()}
        out[("mix", sched, "plan")] = {
            k: v.numpy() for k, v in gather_tree(plan, None).items()}
    # run_federated on the reference's arrays, replaying its key chain
    for spec in RUN_SPECS:
        for sched in SCHEDULES:
            h = run_federated(
                spec, fed, fl=fl, model_init=init,
                system=SYSTEMS["wireless_slow"], keep_state=True, seed=0,
                draws=TapeDraws(tape=inp["tapes"][spec]),
                placement=mesh(sched), device="cpu")
            out[("run", spec, sched)] = _history(h)
    # the other engines and layers, on the reference's draws
    for name, sched in ALL_JOBS.items():
        out[("job", name)] = _history(_port_job(
            name, feds, p0, mesh(sched), TapeDraws(tape=inp["tapes"][name])))
    # a served batch (one that every rank holds, one of 6 that leaves the
    # 4th rank idle at 4 ranks) on the reference's store file
    from repro_torch.fl import DeltaStore, ServeEngine, check_parity
    eng = ServeEngine(DeltaStore.load(inp["store"], device="cpu"),
                      apply_one, placement=mesh(), max_batch=8)
    for users in SERVE_USERS:
        xs = fed.x_val[users, 0]
        check_parity(eng, users, xs)
        out[("serve", len(users))] = eng.serve(users, xs).numpy()
    # an explicit group that does not divide m
    try:
        mesh(group=dist.group.WORLD).stack(p0, world + 1)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    if world < 4:
        return _done(out, out_path)
    # 4 ranks only: every strategy on gspmd, the port's own draws
    fl_all = FLConfig(**dict(FL_KW, cfl_min_rounds=1))
    for spec in ALL_SPECS:
        h = run_federated(spec, fed, fl=fl_all, system=SYSTEMS["wired"],
                          placement=mesh(), device="cpu", keep_state=True)
        out[("all", spec)] = _history(h)
    # the auto rule: the largest divisor of m up to the world size, the
    # placement reused across m = 20, 5 and 6
    p = mesh("shard_map_streams")
    fl1 = FLConfig(rounds=1, local_steps=1, batch_size=8, eval_every=1)
    sizes = []
    for m in (20, 5, 6):
        sub = scenario_label_shift(0, n=30 * m, m=m, device="cpu")
        h = run_federated("ucfl_k2", sub, fl=fl1, placement=p, device="cpu",
                          model_init=lambda gen: lenet.init_params(
                              gen, lenet.LeNetConfig(c1=2, c2=4, fc1=16,
                                                     fc2=12), device="cpu"))
        sizes.append(p.size)
        out[("reuse", m)] = _history(h)
    out["sizes"] = sizes
    _done(out, out_path)


def _done(out, out_path):
    import torch.distributed as dist
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    _worker(*map(int, sys.argv[2:5]), *sys.argv[5:7])
    raise SystemExit(0)


import jax                                               # noqa: E402
import jax.numpy as jnp                                  # noqa: E402
import pytest                                            # noqa: E402

import repro.fl as jfl                                   # noqa: E402
from repro.core.distributed import mix_schedule as j_mix  # noqa: E402
from repro.data.federated import FederatedData as JFederatedData  # noqa
from repro.fl import FLConfig as JFLConfig               # noqa: E402
from repro.fl import DeltaStore as JDeltaStore          # noqa: E402
from repro.fl import MeshShardMap as JMesh               # noqa: E402
from repro.fl import ServeEngine as JServeEngine         # noqa: E402
from repro.fl import run_federated as j_run              # noqa: E402
from repro.fl.comm import SYSTEMS as J_SYSTEMS           # noqa: E402
from repro.models import lenet as jlenet                 # noqa: E402
from repro_torch.convert import tree_from_numpy         # noqa: E402
from repro_torch.data import scenario_label_shift        # noqa: E402
from repro_torch.models import lenet                     # noqa: E402
from repro_torch.core.distributed import (MIX_SCHEDULES,  # noqa: E402
                                          mix_schedule)
from repro_torch.core.aggregation import (stream_aggregate,  # noqa: E402
                                          user_centric_aggregate)
from repro_torch.core.streams import StreamPlan          # noqa: E402
from repro_torch.fl import (DeltaStore, FLConfig, HostVmap,  # noqa: E402
                            MeshShardMap, SYSTEMS, run_federated)
from test_torch_engine import NARROW, ReplayDraws        # noqa: E402

M, N, SEED = 4, 300, 0
_REF4 = r"""
import pickle, sys
import jax, numpy as np
from repro.fl import FLConfig, MeshShardMap, run_federated
from repro.fl.comm import SYSTEMS
from repro.data.federated import FederatedData
from repro.models import lenet
inp = pickle.load(open(sys.argv[1], "rb"))
fed = FederatedData(*(jax.numpy.asarray(a) for a in inp["fed"]))
p0 = jax.tree_util.tree_map(jax.numpy.asarray, inp["params0"])
p = MeshShardMap(schedule="shard_map_streams")
h = run_federated("ucfl_k2", fed, fl=FLConfig(**inp["fl"]),
                  model_init=lambda k: p0, system=SYSTEMS["wireless_slow"],
                  superstep=False, keep_state=True, seed=0, placement=p)
pickle.dump({"devices": len(jax.devices()), "mesh": dict(p.mesh.shape),
             "mean_acc": list(h.mean_acc), "worst_acc": list(h.worst_acc),
             "comm": [tuple(c) for c in h.comm],
             "params": {k: np.asarray(v)
                        for k, v in h.final_params.items()}},
            open(sys.argv[1] + ".ref4", "wb"))
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def case():
    """The port's label-shift arrays and narrow LeNet init, as numpy for
    both packages."""
    fed = scenario_label_shift(1, n=N, m=M, device="cpu")
    jfed = JFederatedData(*(jnp.asarray(t.numpy()) for t in fed))
    params0 = {k: v.numpy() for k, v in lenet.init_params(
        torch.Generator().manual_seed(SEED), lenet.LeNetConfig(
            c1=NARROW.c1, c2=NARROW.c2, fc1=NARROW.fc1, fc2=NARROW.fc2),
        device="cpu").items()}
    return jfed, params0, fed


@pytest.fixture(scope="module")
def case8():
    """The paged jobs' population of 8, for both packages."""
    fed = scenario_label_shift(2, n=600, m=M8, device="cpu")
    return JFederatedData(*(jnp.asarray(t.numpy()) for t in fed)), fed


def _port_run(fed, params0, spec, placement, draws, **kw):
    return run_federated(
        spec, fed, fl=FLConfig(**FL_KW),
        model_init=lambda gen: tree_from_numpy(params0, "cpu"),
        system=SYSTEMS["wireless_slow"], keep_state=True, seed=SEED,
        draws=draws, placement=placement, device="cpu", **kw)


class _Spawned:
    """The 2- and 4-rank gloo groups and the reference's 4-device run,
    started together and read on first use (`get`): the in-process
    reference runs of the other cases overlap them."""

    def __init__(self, procs, path):
        self.procs, self.path, self.out = procs, path, None

    def get(self):
        if self.out is None:
            for p in self.procs:
                assert p.wait(timeout=300) == 0
            path = self.path
            ranks = {w: [pickle.load(open(f"{path}.w{w}.{r}", "rb"))
                         for r in range(w)] for w in (2, 4)}
            jobs = {}
            for part in REF_PARTS:
                with open(f"{path}.ref.{part}", "rb") as f:
                    jobs.update(pickle.load(f))
            with open(path + ".ref4", "rb") as f:
                self.out = ranks, pickle.load(f), jobs
        return self.out


@pytest.fixture(scope="module")
def host_runs(case, case8):
    """{spec or job: (the port's HostVmap History, the draws it took)},
    the reference's key chain replayed and recorded."""
    _, params0, fed = case
    feds = {4: fed, M8: case8[1]}
    out = {}
    for spec in RUN_SPECS:
        tape = TapeDraws(inner=ReplayDraws(SEED, FL_KW["rounds"]))
        out[spec] = (_port_run(fed, params0, spec, HostVmap(), tape),
                     tape.tape)
    for name in ALL_JOBS:
        tape = TapeDraws(inner=ReplayDraws(
            SEED, FL_KW["rounds"], sampler_keys=name == "channel"))
        out[name] = (_port_job(name, feds, params0, HostVmap(), tape),
                     tape.tape)
    return out


@pytest.fixture(scope="module", autouse=True)
def spawned(case, case8, host_runs, tmp_path_factory):
    jfed, params0, fed = case
    tapes = {spec: tape for spec, (_, tape) in host_runs.items()}
    path = str(tmp_path_factory.mktemp("mesh") / "inputs.pkl")
    # the served store: the HostVmap ucfl_k2 run's models, qsgd:4
    DeltaStore.from_history(host_runs["ucfl_k2"][0], codec="qsgd:4",
                            device="cpu").save(path + ".store")
    with open(path, "wb") as f:
        pickle.dump({"fed": [np.asarray(a) for a in jfed],
                     "fed8": [np.asarray(a) for a in case8[0]],
                     "params0": params0, "mix": _mix_inputs(),
                     "tapes": tapes, "fl": FL_KW,
                     "store": path + ".store"}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, __file__, "--worker", str(r), str(world),
             str(port), path, f"{path}.w{world}.{r}"], env=env, cwd=ROOT)
            for r in range(world)]
    # one compute thread in every spawned process: they share the cores
    # with the other test processes
    ref_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                             "--xla_cpu_multi_thread_eigen=false")
    procs.append(subprocess.Popen([sys.executable, "-c", _REF4, path],
                                  env=ref_env, cwd=ROOT))
    # the reference's runs of the jobs, on one device, in two processes
    procs += [subprocess.Popen(
        [sys.executable, __file__, "--reference", path, part],
        env=dict(ref_env, XLA_FLAGS="--xla_cpu_multi_thread_eigen=false"),
        cwd=ROOT) for part in REF_PARTS]
    yield _Spawned(procs, path)
    for p in procs:
        p.kill()
        p.wait()


@pytest.fixture
def ranks(spawned):
    """{world: [each rank's results]}, the reference's 4-device run and
    its one-device runs of the jobs."""
    return spawned.get()


@pytest.fixture(scope="module")
def jruns(case):
    """The reference's mesh run of each spec x schedule (its eventful
    engine, one host device), as `test_torch_engine` holds it."""
    jfed, params0, _ = case
    out = {}
    for spec in RUN_SPECS:
        for sched in SCHEDULES:
            out[spec, sched] = j_run(
                spec, jfed, fl=JFLConfig(**FL_KW),
                model_init=lambda k: jax.tree_util.tree_map(jnp.asarray,
                                                            params0),
                system=J_SYSTEMS["wireless_slow"], superstep=False,
                keep_state=True, seed=SEED, placement=JMesh(schedule=sched))
    return out


def _j_mix(stack, w, asn, sched):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("clients",))
    return {k: np.asarray(v) for k, v in j_mix(
        mesh, ("clients",), {k: jnp.asarray(v) for k, v in stack.items()},
        jnp.asarray(w), None if asn is None else jnp.asarray(asn),
        schedule=sched).items()}


@pytest.mark.parametrize("kind", ["full", "plan"])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_mix_schedule_one_rank(sched, kind):
    stack, w, cen, asn = _mix_inputs()
    mesh = MeshShardMap(schedule=sched, device="cpu")
    tst = {k: torch.from_numpy(v) for k, v in stack.items()}
    if kind == "full":
        got = mesh.mix(tst, torch.from_numpy(w))
        host = user_centric_aggregate(tst, torch.from_numpy(w))
        want = _j_mix(stack, w, None, sched)
    else:
        plan = StreamPlan(torch.from_numpy(cen), torch.from_numpy(asn), None)
        got = mesh.mix_plan(tst, plan)
        host = stream_aggregate(tst, plan)
        want = _j_mix(stack, cen, asn, sched)
    for k in stack:
        assert torch.equal(got[k], host[k]), k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_mix_schedule_errors():
    stack, w, _, _ = _mix_inputs()
    tst = {k: torch.from_numpy(v) for k, v in stack.items()}
    with pytest.raises(ValueError, match="schedule"):
        mix_schedule(None, tst, torch.from_numpy(w), schedule="bogus")
    with pytest.raises(ValueError, match="schedule"):
        MeshShardMap(schedule="bogus", device="cpu")
    assert MIX_SCHEDULES == ("gspmd", "shard_map_streams",
                             "shard_map_unicast")


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("spec", RUN_SPECS)
def test_mesh_one_rank_matches_reference(case, jruns, host_runs, spec,
                                         sched):
    """One rank: the reference's mesh run at `test_torch_engine`'s
    tolerances, and the port's own HostVmap run bitwise, on the draws
    that run took."""
    jfed, params0, fed = case
    want = jruns[spec, sched]
    host, tape = host_runs[spec]
    got = _port_run(fed, params0, spec, MeshShardMap(schedule=sched,
                                                     device="cpu"),
                    TapeDraws(tape=tape))
    assert got.comm == want.comm and got.time == want.time
    flip = 1.0 / (M * jfed.x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip + 1e-6)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(got.final_params[k].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert torch.equal(got.final_params[k], host.final_params[k]), k
    assert got.mean_acc == host.mean_acc


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["full", "plan"])
@pytest.mark.parametrize("sched", SCHEDULES)
def test_mix_schedule_ranks(ranks, world, sched, kind):
    stack, w, cen, asn = _mix_inputs()
    want = (_j_mix(stack, w, None, sched) if kind == "full"
            else _j_mix(stack, cen, asn, sched))
    got = ranks[0][world]
    for r in range(world):
        for k in stack:
            np.testing.assert_allclose(got[r][("mix", sched, kind)][k],
                                       want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("spec", RUN_SPECS)
def test_mesh_ranks_match_reference(ranks, jruns, world, spec, sched):
    """2 and 4 ranks: accuracies within the reference's atol 2e-2,
    `History.comm` equal, every rank the same History."""
    want = jruns[spec, sched]
    got = [r[("run", spec, sched)] for r in ranks[0][world]]
    assert got[0]["comm"] == [tuple(c) for c in want.comm]
    np.testing.assert_allclose(got[0]["mean_acc"], want.mean_acc, atol=2e-2)
    np.testing.assert_allclose(got[0]["worst_acc"], want.worst_acc,
                               atol=2e-2)
    np.testing.assert_allclose(got[0]["time"], want.time, rtol=1e-12)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(got[0]["params"][k], np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for other in got[1:]:
        assert other["mean_acc"] == got[0]["mean_acc"]
        for k in other["params"]:
            np.testing.assert_array_equal(other["params"][k],
                                          got[0]["params"][k])


@pytest.mark.parametrize("spec", ALL_SPECS)
def test_every_strategy_on_the_mesh(case, ranks, spec):
    """Every strategy on gspmd over 4 ranks: the port's HostVmap run
    within atol 2e-2, `History.comm` equal, a clock that moves."""
    _, _, fed = case
    host = run_federated(spec, fed, fl=FLConfig(**dict(FL_KW,
                                                       cfl_min_rounds=1)),
                         system=SYSTEMS["wired"], device="cpu")
    got = ranks[0][4][0][("all", spec)]
    assert len(got["mean_acc"]) == FL_KW["rounds"]
    assert got["comm"] == [tuple(c) for c in host.comm]
    assert got["time"][-1] > 0
    np.testing.assert_allclose(got["mean_acc"], host.mean_acc, atol=2e-2)
    np.testing.assert_allclose(got["worst_acc"], host.worst_acc, atol=2e-2)


def test_mesh_auto_group_and_reuse(ranks):
    """4 ranks: m = 20, 5, 6 give groups of 4, 1 and 3 ranks; the idle
    ranks return rank 0's History; one placement serves all three."""
    got = ranks[0][4]
    for r in range(4):
        assert got[r]["sizes"] == [4, 1, 3]
        for m in (20, 5, 6):
            assert got[r][("reuse", m)]["mean_acc"] == \
                got[0][("reuse", m)]["mean_acc"]
            assert len(got[r][("reuse", m)]["mean_acc"]) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_rejects_indivisible_group(ranks, world):
    for r in range(world):
        assert "not divisible" in ranks[0][world][r]["indivisible"]


def test_mesh_one_rank_group_and_backend():
    import torch.distributed as dist
    p = MeshShardMap(device="cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    p.stack({"w": torch.zeros(2)}, 3)
    assert (p.rank, p.size) == (0, 1)
    assert p.cache_key() == ("MeshShardMap", (0,), "gspmd", "cpu")
    assert "MeshShardMap" in repr(p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MeshShardMap()


def test_reference_at_four_devices(ranks):
    """The reference itself on 4 forced host devices (shard_map_streams,
    ucfl_k2) against the port on 4 gloo ranks."""
    port, ref, _ = ranks
    assert ref["devices"] == 4 and ref["mesh"] == {"clients": 4}
    got = port[4][0][("run", "ucfl_k2", "shard_map_streams")]
    assert got["comm"] == ref["comm"]
    np.testing.assert_allclose(got["mean_acc"], ref["mean_acc"], atol=2e-2)
    np.testing.assert_allclose(got["worst_acc"], ref["worst_acc"],
                               atol=2e-2)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def _match_job(ranks, world, name):
    """Every rank's History of job ``name`` against the reference's
    one-device mesh run (`test_mesh_engines_ranks_match_reference`'s
    tolerances), and every rank the same."""
    want = ranks[2][name]
    got = [r[("job", name)] for r in ranks[0][world]]
    g = got[0]
    for field in ("rounds", "comm", "comm_bits", "time", "extra", "hier"):
        assert g[field] == want[field], field
    np.testing.assert_allclose(g["mean_acc"], want["mean_acc"], atol=2e-2)
    np.testing.assert_allclose(g["worst_acc"], want["worst_acc"],
                               atol=2e-2)
    outside = total = 0
    for k, v in want["params"].items():
        gp = g["params"][k]
        assert gp.shape == v.shape, k
        if name not in LEVELS:
            np.testing.assert_allclose(gp, v, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        d = np.abs(gp - v)
        outside += int((d > 1e-5 + 1e-4 * np.abs(v)).sum())
        total += v.size
        assert d.max() <= 1e-2, (k, d.max())
    assert outside <= total // 1000, (outside, total)
    for other in got[1:]:
        assert other["mean_acc"] == g["mean_acc"]
        for k in g["params"]:
            np.testing.assert_array_equal(other["params"][k],
                                          g["params"][k])


# the jobs whose uplink or edge codec is qsgd: a value one rounding off
# may cross a level (the FMA of the reference's jnp crossing, the rows a
# rank's GEMMs batch), so their params allow level flips as
# test_torch_hierarchy's edge runs do
LEVELS = ("channel", "async", "paged", "hier")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(JOBS))
def test_mesh_engines_ranks_match_reference(ranks, world, name):
    """2 and 4 ranks: the eventful engine with a sampler and qsgd:4, a
    faulted run, async K = 2 of 4, a paged and a paged async run, a
    two-level qsgd:4 hierarchy run, each against the reference's mesh
    run: rounds, comm, comm bits, the clock and the extras equal, the
    accuracies within atol 2e-2, the params at test_torch_engine's
    tolerances (level flips allowed under qsgd: at most 0.1 % of
    elements outside them, none past 1e-2); every rank the same
    History."""
    _match_job(ranks, world, name)


@pytest.mark.parametrize("world", [2, 4])
def test_serve_ranks_match_reference(case, spawned, ranks, world):
    """A served batch of 8 (every rank holds rows) and of 6 (at 4 ranks
    the auto group is 3: the 4th rank receives rank 0's output) on a
    qsgd:4 store file, `check_parity` on the mesh, the logits within the
    served atol 1e-5 of the reference's mesh `ServeEngine` on the same
    file."""
    jfed = case[0]
    jeng = JServeEngine(JDeltaStore.load(spawned.path + ".store"),
                        lambda p, x: jlenet.apply(p, x[None])[0],
                        placement=JMesh(), max_batch=8)
    for users in SERVE_USERS:
        want = np.asarray(jeng.serve(users, jfed.x_val[np.asarray(users),
                                                       0]))
        for r in range(world):
            got = ranks[0][world][r][("serve", len(users))]
            np.testing.assert_allclose(got, want, atol=1e-5,
                                       err_msg=f"rank {r} batch "
                                               f"{len(users)}")


@pytest.mark.parametrize("world", [2, 4])
def test_async_paged_uneven_cohorts_match_reference(ranks, host_runs,
                                                    world):
    """A paged async cohort that does not shard over every rank runs on
    the auto group for its size, the other ranks receiving the event's
    rows: K = 3 at every event and a crash-shrunk cohort of 3 mid-run,
    every rank against the reference's single-controller run at the
    other jobs' tolerances, and every rank the same History.  At 2 ranks
    a cohort of 3 runs on rank 0 alone, bitwise the port's one-process
    run."""
    for name in UNEVEN:
        _match_job(ranks, world, name)
    if world == 2:
        host = host_runs["apaged3"][0]
        for r in range(world):
            got = ranks[0][world][r][("job", "apaged3")]
            assert got["mean_acc"] == list(host.mean_acc)
            for k, v in host.final_params.items():
                np.testing.assert_array_equal(got["params"][k], v.numpy(),
                                              err_msg=f"rank {r} {k}")


def _reference_jobs(path, part):
    """The reference's one-device mesh run of each job of ``part`` (a
    key of `REF_PARTS`) on the inputs at ``path``, written to
    ``path.ref.<part>`` (run as ``python tests/test_torch_mesh.py
    --reference path part``, beside the ranks)."""
    with open(path, "rb") as f:
        inp = pickle.load(f)
    feds = {n: JFederatedData(*(jnp.asarray(a) for a in inp[key]))
            for n, key in ((4, "fed"), (M8, "fed8"))}
    out = {}
    for name in REF_PARTS[part]:
        sched = ALL_JOBS[name]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            h = j_run(
                "ucfl_k2", feds[M8 if "paged" in name else 4],
                fl=JFLConfig(**FL_KW),
                model_init=lambda k: jax.tree_util.tree_map(
                    jnp.asarray, inp["params0"]),
                system=J_SYSTEMS["wireless_slow"], keep_state=True,
                seed=SEED, placement=JMesh(schedule=sched),
                **_job_kwargs(name, jfl, ref=True))
        out[name] = _history(h)
    with open(f"{path}.ref.{part}", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__" and sys.argv[1:2] == ["--reference"]:
    _reference_jobs(*sys.argv[2:4])
