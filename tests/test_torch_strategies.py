"""The port's cfl and fedfomo against the reference, on the CPU.

`run_federated("cfl" | "fedfomo", ...)` on the reference's label-shift
arrays (m = 8) with a narrow LeNet and the reference's params0, the
reference run eventful (``superstep=False``; its own fused and eventful
runs agree), the port's draws replaying the reference's key chain
(`ReplayDraws`): comm, comm bits and the clock exact, cfl's cluster
assignment exact, accuracies within one argmax flip, final params within
rtol 1e-4 / atol 1e-5.  cfl's thresholds are set far from the run's
norms (``cfl_eps1`` 10, ``cfl_eps2`` 0, splits from round 1), so no split
decision sits within rounding of its threshold.  Then fedfomo's fused
run against its eventful one, bitwise; the weighting (`fomo_weights`)
against the reference's on the same stacks, with the ``[i, j]``
orientation of the candidate losses pinned against a per-model loop and
``candidates >= m`` disabling the top-M cut; and the quarantine
reweighting of both mixing dispatchers.
"""
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
from repro.fl.strategies import quarantine_reweight as j_quarantine_reweight
from repro.fl.strategies.fedfomo import fomo_weights as j_fomo_weights
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.fl import (SYSTEMS, Channel, ClusterExtras, FLConfig,
                            UniformFraction, run_federated)
from repro_torch.fl.placement import HostVmap
from repro_torch.fl.strategies import (RoundContext, TracedMix,
                                       quarantine_reweight)
from repro_torch.fl.strategies.fedfomo import (candidate_losses,
                                               fomo_weights, self_losses)
from repro_torch.models import lenet
from test_torch_engine import ReplayDraws

SEED = 0
M, N = 8, 400
FL_KW = dict(rounds=4, local_steps=2, batch_size=8, eval_every=2,
             cfl_eps1=10.0, cfl_eps2=0.0, cfl_min_rounds=1)
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


def _runs(case, spec, sampled, codec, **fl_kw):
    """(reference eventful, port) Histories of one configuration."""
    jfed, params0, fed = case
    fl_kw = dict(FL_KW, **fl_kw)
    jkw, kw = {}, {}
    if sampled:
        jkw["sampler"], kw["sampler"] = (JUniformFraction(0.5),
                                         UniformFraction(0.5))
    if codec is not None:
        jkw["channel"] = JChannel(codec=codec, link="tiered:4")
        kw["channel"] = Channel(codec=codec, link="tiered:4")
    want = j_run(spec, jfed, fl=JFLConfig(**fl_kw),
                 model_init=lambda k: jlenet.init_params(k, NARROW),
                 system=J_SYSTEMS["wireless_slow"], superstep=False,
                 keep_state=True, seed=SEED, **jkw)
    got = run_federated(
        spec, fed, fl=FLConfig(**fl_kw),
        model_init=lambda gen: tree_from_numpy(params0, "cpu"),
        system=SYSTEMS["wireless_slow"], keep_state=True, seed=SEED,
        draws=ReplayDraws(SEED, fl_kw["rounds"], sampler_keys=sampled),
        device="cpu", **kw)
    return want, got


def _assert_matches(case, want, got):
    jfed = case[0]
    assert got.rounds == want.rounds
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert [tuple(c) for c in got.comm_bits] == [tuple(c)
                                                for c in want.comm_bits]
    assert got.time == want.time
    assert got.extra.get("channel") == want.extra.get("channel")
    flip = 1.0 / (M * jfed.x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip + 1e-6)
    gp = tree_to_numpy(got.final_params)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("sampled,codec", [(False, None), (True, "qsgd:4")],
                         ids=["full", "sampler_qsgd4"])
def test_cfl_matches_reference_eventful(case, sampled, codec):
    """Round 1 splits the active clients by the cosine bipartition of
    their deltas; the assignment, the streams it charges and the models
    follow the reference's exactly (cfl runs eventful in both packages:
    its state changes between rounds)."""
    want, got = _runs(case, "cfl", sampled, codec)
    _assert_matches(case, want, got)
    assert isinstance(got.extras, ClusterExtras)
    np.testing.assert_array_equal(got.extras.clusters,
                                  want.extras.clusters)
    np.testing.assert_array_equal(got.extra["clusters"],
                                  want.extra["clusters"])
    assert got.comm[-1].n_streams > 1            # at least one split
    with pytest.raises(ValueError, match="cannot fuse.*not traceable"):
        run_federated("cfl", case[2], fl=FLConfig(**FL_KW), superstep=True,
                      device="cpu")


@pytest.mark.parametrize("sampled,codec", [(False, None), (True, "qsgd:4")],
                         ids=["full", "sampler_qsgd4"])
def test_fedfomo_matches_reference_eventful(case, sampled, codec):
    want, got = _runs(case, "fedfomo", sampled, codec)
    _assert_matches(case, want, got)
    assert got.comm[0] == (0, M * FL_KW.get("fomo_candidates", 5))


@pytest.mark.parametrize("sampled,codec", [(False, None), (True, "qsgd:4")],
                         ids=["full", "sampler_qsgd4"])
def test_fedfomo_fused_equals_eventful_bitwise(case, sampled, codec):
    _, params0, fed = case
    kw = dict(fl=FLConfig(**FL_KW),
              model_init=lambda gen: tree_from_numpy(params0, "cpu"),
              system=SYSTEMS["wireless_slow"], keep_state=True, seed=3,
              device="cpu",
              sampler=UniformFraction(0.5) if sampled else None)
    if codec is not None:
        kw["channel"] = Channel(codec=codec, link="tiered:4")
    a = run_federated("fedfomo", fed, **kw)
    b = run_federated("fedfomo", fed, superstep=False, **kw)
    assert (a.rounds, a.mean_acc, a.worst_acc, a.time, a.comm,
            a.comm_bits) == (b.rounds, b.mean_acc, b.worst_acc, b.time,
                             b.comm, b.comm_bits)
    for part in ("final_params", "final_residual"):
        ta, tb = getattr(a, part), getattr(b, part)
        assert (ta is None) == (tb is None)
        for k in ta or {}:
            assert torch.equal(ta[k].view(torch.int32),
                               tb[k].view(torch.int32)), (part, k)


def _stacks(case, scale=0.05, seed=7):
    """(prev, stacked) client stacks as numpy: params0 and a perturbed
    copy per client."""
    _, params0, _ = case
    rng = np.random.default_rng(seed)
    prev = {k: np.repeat(v[None], M, 0) for k, v in params0.items()}
    stacked = {k: (v + scale * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in prev.items()}
    return prev, stacked


def test_fedfomo_candidate_loss_orientation(case):
    """losses[i, j] is candidate j's loss on client i's OWN validation set
    (pinned against a per-model loop and the reference's batched matrix),
    the self losses its diagonal."""
    jfed, _, fed = case
    _, stacked = _stacks(case)
    st = tree_from_numpy(stacked, "cpu")
    got = candidate_losses(lenet.loss_fn, st, fed.x_val, fed.y_val)
    want = np.zeros((M, M), np.float32)
    for j in range(M):
        pj = {k: v[j] for k, v in st.items()}
        for i in range(M):
            want[i, j] = float(lenet.loss_fn(
                pj, {"x": fed.x_val[i], "y": fed.y_val[i]})[0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    diag = self_losses(lenet.loss_fn, st, fed.x_val, fed.y_val)
    np.testing.assert_allclose(diag.numpy(), np.diag(got.numpy()), atol=1e-6)
    per_client = jax.vmap(lambda p, x, y: jlenet.loss_fn(
        p, {"x": x, "y": y})[0], in_axes=(None, 0, 0))
    jlosses = jax.vmap(per_client, in_axes=(0, None, None))(
        stacked, jfed.x_val, jfed.y_val).T
    np.testing.assert_allclose(got.numpy(), np.asarray(jlosses), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_cand", [1, 3, 5, M, M + 3])
def test_fomo_weights_match_reference(case, n_cand):
    """The weighting on the same stacks: the (m, m) matrix and the residual
    mass against the reference's within the engine's rtol 1e-4 / atol
    1e-5 (each weight divides a difference of two close losses, which
    amplifies the two packages' f32 rounding of the losses), with the same
    positive entries; ``candidates >= m`` keeps every positive weight (no top-M
    cut)."""
    jfed, _, fed = case
    prev, stacked = _stacks(case, seed=n_cand)
    jw, jkeep = j_fomo_weights(jlenet.loss_fn, stacked, prev, jfed.x_val,
                               jfed.y_val, jnp.int32(n_cand))
    w, keep = fomo_weights(lenet.loss_fn, tree_from_numpy(stacked, "cpu"),
                           tree_from_numpy(prev, "cpu"), fed.x_val,
                           fed.y_val, torch.tensor(n_cand))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(keep.numpy(), np.asarray(jkeep), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(w.numpy() > 0, np.asarray(jw) > 0)
    if n_cand >= M:
        # every candidate that lowers the client's loss keeps its weight
        st, pv = tree_from_numpy(stacked, "cpu"), tree_from_numpy(prev, "cpu")
        gain = (self_losses(lenet.loss_fn, pv, fed.x_val, fed.y_val)[:, None]
                - candidate_losses(lenet.loss_fn, st, fed.x_val, fed.y_val))
        assert torch.equal(w > 0, gain > 0)
        # ... where a cut at 3 would have dropped some
        assert int((gain > 0).sum(1).max()) > 3
    else:
        assert int((w > 0).sum(1).max()) <= n_cand


def test_quarantine_reweight_in_both_dispatchers(case):
    """`quarantine_reweight` against the reference's; `RoundContext.mix`,
    `mix_plan` and `TracedMix` apply it, the plan's to its centroids."""
    rng = np.random.default_rng(5)
    w = rng.uniform(size=(M, M)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    q = (rng.uniform(size=M) < 0.6).astype(np.float32)
    q[0] = 0.0
    got = quarantine_reweight(torch.from_numpy(w), torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_quarantine_reweight(jnp.asarray(w), jnp.asarray(q))), rtol=1e-6,
        atol=1e-7)
    assert bool(torch.all(got[:, q == 0] == 0))
    torch.testing.assert_close(got.sum(1), torch.from_numpy(w).sum(1))
    assert torch.equal(quarantine_reweight(torch.from_numpy(w),
                                           torch.zeros(M)),
                       torch.from_numpy(w))
    _, stacked = _stacks(case)
    st, wt, qt = (tree_from_numpy(stacked, "cpu"), torch.from_numpy(w),
                  torch.from_numpy(q))
    placement = HostVmap()
    ctx = RoundContext(fed=case[2], fl=None, loss_fn=None, acc_fn=None,
                       params0=None, seed=0, draws=None, placement=placement,
                       quarantine=qt)
    tmix = TracedMix(placement)
    tmix.quarantine = qt
    want = placement.mix(st, got)
    for mixed in (ctx.mix(st, wt), tmix.mix(st, wt)):
        for k in want:
            assert torch.equal(mixed[k], want[k]), k
    from repro_torch.core.streams import StreamPlan
    cents, assign = wt[:3], torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
    want = placement.mix_plan(st, StreamPlan(
        quarantine_reweight(cents, qt), assign, None))
    for mixed in (ctx.mix_plan(st, StreamPlan(cents, assign, None)),
                  tmix.mix_plan(st, cents, assign)):
        for k in want:
            assert torch.equal(mixed[k], want[k]), k
