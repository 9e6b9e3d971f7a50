"""The port's fused superstep on the CPU, mirroring tests/test_superstep.py.

On the CPU a chunk runs the fused round function eagerly (on the card it
is a captured CUDA graph, held in `tests/test_torch_gpu.py`).  The fused
run must reproduce the port's eventful loop EXACTLY (accuracy history,
comm, clock, comm_bits and final params and residuals) for every
registered strategy, with and without a sampler, with every codec
family; and match the reference's own default (fused) run fed the same
draws (`ReplayDraws`) at `test_run_federated_matches_reference`'s
tolerances, clock and comm exact.  Then the dispatch: the
`superstep_support` matrix, the fallback of a subclass that overrides
``aggregate`` only, ``superstep=True`` refusing what cannot fuse, the
chunk schedule against the eventful eval rounds, and the cache reused
across runs.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.federated import scenario_label_shift as j_label_shift
from repro.fl import Channel as JChannel
from repro.fl import FLConfig as JFLConfig
from repro.fl import UniformFraction as JUniformFraction
from repro.fl import run_federated as j_run
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.data import scenario_label_shift
from repro_torch.fl import (SYSTEMS, Channel, FLConfig, FullParticipation,
                            MeshShardMap, UniformFraction,
                            available_strategies, get_strategy,
                            run_federated, superstep_support)
from repro_torch.fl import simulator as sim
from repro_torch.fl.strategies import ClientSampler, FedAvg
from repro_torch.models import lenet
from test_torch_engine import ReplayDraws

FL = FLConfig(rounds=5, local_steps=2, batch_size=8, eval_every=2)
NARROW = lenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
SPECS = ["fedavg", "local", "oracle", "ucfl", "ucfl_k2"]
CODECS = [None, "qsgd:4", "topk:0.1", "adaptive"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every run here is tiny: PyTorch's intra-op threads only contend
    with the other test processes (the comparisons are run against runs
    made in the same setting)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fed():
    return scenario_label_shift(2, n=300, m=4, device="cpu")


def _init(gen):
    return lenet.init_params(gen, NARROW, device="cpu")


def _both(spec, fed, **kw):
    """(fused, eventful) Histories of one configuration, keep_state."""
    kw = dict(fl=FL, model_init=_init, system=SYSTEMS["wireless_slow"],
              keep_state=True, device="cpu", **kw)
    return (run_federated(spec, fed, **kw),
            run_federated(spec, fed, superstep=False, **kw))


def _assert_same_run(a, b):
    assert (a.rounds, a.mean_acc, a.worst_acc, a.time, a.comm,
            a.comm_bits) == (b.rounds, b.mean_acc, b.worst_acc, b.time,
                             b.comm, b.comm_bits)
    assert a.extra.get("channel") == b.extra.get("channel")
    for part in ("final_params", "final_residual"):
        ta, tb = getattr(a, part), getattr(b, part)
        assert (ta is None) == (tb is None)
        for k in ta or {}:
            assert ta[k].dtype == tb[k].dtype
            assert torch.equal(ta[k].view(torch.int32),
                               tb[k].view(torch.int32)), (part, k)
    for k, v in b.final_opt_state["mu"].items():
        assert torch.equal(a.final_opt_state["mu"][k], v), k
    assert torch.equal(a.final_opt_state["step"], b.final_opt_state["step"])


# ---------------------------------------------------------------------------
# bit parity: fused against the port's eventful loop


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: c or "raw")
@pytest.mark.parametrize("sampled", [False, True], ids=["full", "sampler"])
@pytest.mark.parametrize("spec", SPECS)
def test_fused_equals_eventful_bitwise(spec, sampled, codec, fed):
    """Masks, EF residuals, the clock and the comm bits replay bitwise
    through the fused path; the tiered link makes the clock per client."""
    h_ss, h_ev = _both(
        spec, fed, sampler=UniformFraction(0.5) if sampled else None,
        channel=None if codec is None else Channel(codec=codec,
                                                   link="tiered:4"))
    _assert_same_run(h_ss, h_ev)
    assert h_ss.rounds == [0, 2, 4]
    assert len(h_ss.comm) == FL.rounds
    if codec is not None:
        assert len(h_ss.comm_bits) == FL.rounds


@pytest.mark.parametrize("schedule,sampled,codec", [
    ("gspmd", False, None), ("gspmd", True, "qsgd:4"),
    ("shard_map_streams", False, "topk:0.1"),
    ("shard_map_streams", True, "qsgd:4"),
    ("shard_map_unicast", False, "qsgd:4"), ("shard_map_unicast", True,
                                             None)])
def test_fused_equals_eventful_on_the_mesh(schedule, sampled, codec, fed):
    """The mesh placement (one rank): fused = eventful bitwise for
    ucfl_k2, and both bitwise the `HostVmap` run, the codec on the mesh's
    ``"jnp"`` backend (the reference's `test_superstep_bit_parity` and
    `test_superstep_parity_sampler_codec`, mesh half)."""
    kw = dict(sampler=UniformFraction(0.5) if sampled else None,
              channel=None if codec is None else Channel(codec=codec,
                                                         link="tiered:4"))
    mesh = MeshShardMap(schedule=schedule, device="cpu")
    h_ss, h_ev = _both("ucfl_k2", fed, placement=mesh, **kw)
    _assert_same_run(h_ss, h_ev)
    host, _ = _both("ucfl_k2", fed, **kw)
    if codec != "topk:0.1":
        _assert_same_run(h_ss, host)
    else:       # the exact k-th magnitude against the bisection cutoff
        for k, v in host.final_params.items():
            np.testing.assert_allclose(h_ss.final_params[k].numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-5)


def test_full_participation_sampler_equals_no_sampler(fed):
    """FullParticipation fuses with all-True masks: bitwise the run with no
    sampler, on both engines."""
    h_full = _both("ucfl_k2", fed, sampler=FullParticipation(),
                   channel=Channel(codec="qsgd:4"))
    h_none = _both("ucfl_k2", fed, channel=Channel(codec="qsgd:4"))
    for a, b in zip(h_full, h_none):
        _assert_same_run(a, b)


# ---------------------------------------------------------------------------
# the reference's default (fused) run, fed the same draws

SEED, M, N = 0, 4, 300
FL_KW = dict(rounds=3, local_steps=2, batch_size=8, eval_every=2)
JNARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)


@pytest.fixture(scope="module")
def case():
    jfed = j_label_shift(jax.random.PRNGKey(0), n=N, m=M)
    kinit = jax.random.split(jax.random.PRNGKey(SEED))[1]
    params0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        jlenet.init_params, static_argnums=1)(kinit, JNARROW))
    return jfed, params0, fed_from_numpy(*(np.asarray(a) for a in jfed),
                                         device="cpu")


@pytest.mark.parametrize("spec,sampled,codec", [
    ("ucfl_k2", False, None), ("fedavg", False, None),
    ("ucfl_k2", True, "qsgd:4"), ("fedavg", True, "topk:0.25")])
def test_fused_matches_reference_fused(case, spec, sampled, codec,
                                      monkeypatch):
    """Both sides on their default engine (the reference's `lax.scan`
    superstep, the port's fused chunks): comm, comm_bits and the clock
    exact, accuracies within one argmax flip, final params within rtol
    1e-4 / atol 1e-5."""
    jfed, params0, fed = case
    jkw, kw = {}, {}
    if sampled:
        jkw["sampler"], kw["sampler"] = (JUniformFraction(0.5),
                                         UniformFraction(0.5))
    if codec is not None:
        jkw["channel"] = JChannel(codec=codec, link="tiered:4")
        kw["channel"] = Channel(codec=codec, link="tiered:4")
    want = j_run(spec, jfed, fl=JFLConfig(**FL_KW),
                 model_init=lambda k: jlenet.init_params(k, JNARROW),
                 system=J_SYSTEMS["wireless_slow"], keep_state=True,
                 seed=SEED, **jkw)
    calls = []
    orig = sim._run_superstep
    monkeypatch.setattr(sim, "_run_superstep",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = run_federated(
        spec, fed, fl=FLConfig(**FL_KW),
        model_init=lambda gen: tree_from_numpy(params0, "cpu"),
        system=SYSTEMS["wireless_slow"], keep_state=True, seed=SEED,
        draws=ReplayDraws(SEED, FL_KW["rounds"], sampler_keys=sampled),
        device="cpu", **kw)
    assert calls == [1]                     # the port's run fused
    assert got.rounds == want.rounds == [0, 2]
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert [tuple(c) for c in got.comm_bits] == [tuple(c)
                                                for c in want.comm_bits]
    assert got.time == want.time
    flip = 1.0 / (M * jfed.x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip + 1e-6)
    gp = tree_to_numpy(got.final_params)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# dispatch


class _Eventful(ClientSampler):
    """A sampler without `sample_traced`."""

    def sample(self, rnd, m, draws):
        return None


class _NotTraceable(FedAvg):
    name = "not_traceable_test"
    traceable = False


class _ScaledAvg(FedAvg):
    """Overrides the eventful hook only: must not fuse."""
    name = "scaled_avg_test"

    def aggregate(self, state, stacked, prev, ctx):
        return ctx.mix(stacked, 0.5 * state), state


class _BothAvg(FedAvg):
    """Overrides both hooks: stays fusible."""
    name = "both_avg_test"

    def aggregate(self, state, stacked, prev, ctx):
        return ctx.mix(stacked, state), state

    def aggregate_traced(self, arrays, stacked, prev, tmix):
        return tmix.mix(stacked, arrays)


def test_superstep_support_matrix():
    assert ({s.split("_k")[0] for s in SPECS} | {"cfl", "fedfomo"}
            == set(available_strategies()))
    for spec in SPECS + ["fedfomo"]:
        for sampler in (None, UniformFraction(0.5), FullParticipation()):
            assert superstep_support(get_strategy(spec), sampler) == (True,
                                                                      "")
    ok, why = superstep_support(get_strategy("cfl"), None)
    assert not ok and "'cfl' is not traceable" in why
    ok, why = superstep_support(_NotTraceable(), None)
    assert not ok and "not traceable" in why
    ok, why = superstep_support(get_strategy("fedavg"), _Eventful())
    assert not ok and "sample_traced" in why
    ok, why = superstep_support(_ScaledAvg(), None)
    assert not ok and "aggregate" in why
    assert superstep_support(_BothAvg(), None) == (True, "")


def test_subclass_override_falls_back_to_eventful(fed):
    """The default runs `_ScaledAvg` eventful (its own rule, not the
    parent's fused one) and superstep=True refuses it."""
    kw = dict(fl=FL, model_init=_init, device="cpu")
    auto = run_federated(strategy=_ScaledAvg(), fed=fed, **kw)
    ev = run_federated(strategy=_ScaledAvg(), fed=fed, superstep=False, **kw)
    parent = run_federated("fedavg", fed, superstep=False, **kw)
    assert auto.mean_acc == ev.mean_acc != parent.mean_acc
    with pytest.raises(ValueError, match="cannot fuse"):
        run_federated(strategy=_ScaledAvg(), fed=fed, superstep=True, **kw)


def test_superstep_true_raises_for_what_cannot_fuse(fed):
    kw = dict(fl=FL, model_init=_init, device="cpu", superstep=True)
    with pytest.raises(ValueError, match="cannot fuse.*sample_traced"):
        run_federated("fedavg", fed, sampler=_Eventful(), **kw)
    with pytest.raises(ValueError, match="cannot fuse.*not traceable"):
        run_federated(strategy=_NotTraceable(), fed=fed, **kw)
    with pytest.raises(ValueError, match="cannot fuse.*'cfl'"):
        run_federated("cfl", fed, **kw)
    # the async runtime is event-driven: the reference's TypeError
    with pytest.raises(TypeError, match="superstep fusion"):
        run_federated("fedavg", fed, async_cfg=object(), **kw)
    # an eventful sampler under the default runs the eventful loop
    h = run_federated("fedavg", fed, sampler=_Eventful(), fl=FL,
                      model_init=_init, device="cpu")
    assert h.rounds == [0, 2, 4]


@pytest.mark.parametrize("rounds,every", [(60, 5), (5, 2), (1, 1), (3, 10),
                                          (8, 8), (9, 4), (20, 5), (0, 3)])
def test_eval_rounds_match_eventful_schedule(rounds, every):
    chunks = list(sim._eval_rounds(rounds, every))
    want = [r for r in range(rounds) if r % every == 0 or r == rounds - 1]
    assert [last for _, last in chunks] == want
    assert [r for first, last in chunks
            for r in range(first, last + 1)] == list(range(rounds))
    if (rounds, every) == (20, 5):       # chip_smoke's [main]: 3 lengths
        assert [b - a + 1 for a, b in chunks] == [1, 5, 5, 5, 4]


def test_superstep_cache_reused_across_runs(fed):
    """Two runs of one configuration share the superstep cache entry and
    its chunks (one per chunk length); a third with another codec adds an
    entry."""
    sim._SUPERSTEP_FNS.clear()
    kw = dict(fl=FL, model_init=_init, device="cpu")
    run_federated("ucfl_k2", fed, **kw)
    (key, entry), = sim._SUPERSTEP_FNS.items()
    chunks = dict(entry)
    assert sorted(k[0] for k in chunks) == [1, 2]     # chunks of 1, 2, 2
    run_federated("ucfl_k2", fed, **kw)
    assert list(sim._SUPERSTEP_FNS) == [key]
    assert sim._SUPERSTEP_FNS[key] is entry
    assert all(entry[k] is fn for k, fn in chunks.items())
    run_federated("ucfl_k2", fed, channel="qsgd:4", **kw)
    assert len(sim._SUPERSTEP_FNS) == 2
