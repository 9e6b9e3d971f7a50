"""Port round engine with a sampler and the uplink channel, against the
reference, end to end on the CPU.

`run_federated` with ``sampler=`` and ``channel=`` on the reference's
label-shift arrays (two ground-truth groups, so the oracle has two
streams) with a narrow LeNet and the reference's params0, the reference
run eventful (``superstep=False``, its Pallas kernels in interpret mode).
The port's draws replay the reference's key chain, sampler keys and
codec noise included (`ReplayDraws`).  History.comm, comm_bits, time
and extra["channel"] must match exactly, accuracies within one argmax
flip, final params within rtol 1e-4 / atol 1e-5.
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
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.fl import (Channel, FLConfig, FullParticipation, SYSTEMS,
                            UniformFraction, run_federated)
from repro_torch.kernels import ops
from test_torch_engine import ReplayDraws

SEED = 0
M, N = 4, 300
FL_KW = dict(rounds=3, local_steps=2, batch_size=8, eval_every=1)
NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def case():
    jfed = j_label_shift(jax.random.PRNGKey(0), n=N, m=M)
    jfed = jfed._replace(group=jnp.asarray(np.arange(M) % 2, jnp.int32))
    kinit = jax.random.split(jax.random.PRNGKey(SEED))[1]
    params0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        jlenet.init_params, static_argnums=1)(kinit, NARROW))
    fed = fed_from_numpy(*(np.asarray(a) for a in jfed), device="cpu")
    return jfed, params0, fed


def _runs(case, spec, codec, link, sampler_kw, system="wireless_slow"):
    jfed, params0, fed = case
    jsampler = None if sampler_kw is None else JUniformFraction(**sampler_kw)
    sampler = None if sampler_kw is None else UniformFraction(**sampler_kw)
    want = j_run(spec, jfed, fl=JFLConfig(**FL_KW),
                 model_init=lambda k: jlenet.init_params(k, NARROW),
                 system=J_SYSTEMS[system], superstep=False, keep_state=True,
                 seed=SEED, sampler=jsampler,
                 channel=JChannel(codec=codec, link=link))
    before = dict(ops.LAUNCHES)
    got = run_federated(
        spec, fed, fl=FLConfig(**FL_KW),
        model_init=lambda gen: tree_from_numpy(params0, "cpu"),
        system=SYSTEMS[system], keep_state=True, seed=SEED, sampler=sampler,
        channel=Channel(codec=codec, link=link),
        draws=ReplayDraws(SEED, FL_KW["rounds"],
                          sampler_keys=sampler is not None), device="cpu")
    assert ops.LAUNCHES == before            # CPU tensors: plain versions
    return want, got


@pytest.mark.parametrize("spec,codec,link,sampler_kw,streams", [
    ("ucfl_k2", "qsgd:4", "tiered:4", dict(fraction=0.5), 2),
    ("fedavg", "topk:0.25", "uniform", None, 1),
    ("oracle", "adaptive", "lognormal:0.5", dict(count=2), 2),
    ("local", "qsgd:8", None, None, 0),
])
def test_channel_run_matches_reference(case, spec, codec, link, sampler_kw,
                                       streams):
    jfed = case[0]
    want, got = _runs(case, spec, codec, link, sampler_kw)
    assert got.rounds == want.rounds
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert got.comm[0] == (streams, 0)
    assert [tuple(c) for c in got.comm_bits] == \
        [tuple(c) for c in want.comm_bits]
    assert len(got.comm_bits) == FL_KW["rounds"]
    assert got.time == want.time
    assert got.extra["channel"] == want.extra["channel"]
    flip = 1.0 / (M * jfed.x_val.shape[1])
    np.testing.assert_allclose(got.mean_acc, want.mean_acc, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got.worst_acc, want.worst_acc, rtol=0,
                               atol=flip + 1e-6)
    gp = tree_to_numpy(got.final_params)
    for k, v in want.final_params.items():
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    go = tree_to_numpy(got.final_opt_state)
    np.testing.assert_array_equal(go["step"], np.asarray(
        want.final_opt_state["step"]))


def test_identity_channel_keeps_the_channel_less_clock(case):
    _, params0, fed = case
    runs = {}
    for name, kw in (("none", {}), ("identity", dict(channel=Channel())),
                     ("full", dict(channel="identity",
                                   sampler=FullParticipation()))):
        runs[name] = run_federated(
            "ucfl_k2", fed, fl=FLConfig(**FL_KW),
            model_init=lambda gen: tree_from_numpy(params0, "cpu"),
            system=SYSTEMS["wireless_slow"], seed=SEED,
            draws=ReplayDraws(SEED, FL_KW["rounds"]), device="cpu", **kw)
    base = runs["none"]
    assert base.comm_bits == [] and "channel" not in base.extra
    for name in ("identity", "full"):
        h = runs[name]
        assert h.time == base.time              # bit-identical, not approx
        assert h.mean_acc == base.mean_acc and h.comm == base.comm
        mb = h.extra["channel"]["model_bits"]
        assert h.extra["channel"]["payload_bits"] == mb
        assert [tuple(c) for c in h.comm_bits] == \
            [(h.comm[0].n_streams * mb, M * mb)] * FL_KW["rounds"]
