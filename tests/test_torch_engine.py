"""Port round engine against the reference, end to end on the CPU.

`run_federated` for ucfl, ucfl_k2 and fedavg on the reference's
label-shift arrays with a narrow LeNet and the reference's params0.  The
port's draws replay the reference's JAX key chain (`ReplayDraws` below),
so both runs see the same minibatches and the same k-means start.
History.comm and History.time must match exactly, accuracies within one
argmax flip (1/(m·n_val)), final params within rtol 1e-4 / atol 1e-5.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.federated import scenario_label_shift as j_label_shift
from repro.fl import FLConfig as JFLConfig
from repro.fl import run_federated as j_run
from repro.fl.comm import SYSTEMS as J_SYSTEMS
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy, tree_to_numpy
from repro_torch.data import scenario_label_shift
from repro_torch.fl import (FLConfig, SYSTEMS, TorchDraws, run_federated)
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
M, N = 4, 300
FL_KW = dict(rounds=3, local_steps=2, batch_size=8, eval_every=1)
NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)


class ReplayDraws:
    """The reference engine's draws, replayed from its key chain:
    PRNGKey(seed) -> split -> (key, kinit); per round key, kround =
    split(key), ckeys = split(kround, m); per client split(ckey, S); per
    step randint(k, (B,), 0, 2**30) % max(n_i, 1) % n_slots.  The k-means
    start is randint(PRNGKey(seed + 1), (), 0, m)."""

    def __init__(self, seed, rounds):
        key = jax.random.PRNGKey(seed)
        key, _ = jax.random.split(key)
        self.krounds = []
        for _ in range(rounds):
            key, kround = jax.random.split(key)
            self.krounds.append(kround)
        self.seed = seed

    def batch_indices(self, rnd, n, n_slots, batch_size, local_steps):
        m = n.shape[0]

        def client(ckey, n_i):
            keys = jax.random.split(ckey, local_steps)
            r = jax.vmap(lambda k: jax.random.randint(
                k, (batch_size,), 0, 1 << 30))(keys)
            return r % jnp.maximum(n_i.astype(jnp.int32), 1) % n_slots

        idx = jax.vmap(client)(jax.random.split(self.krounds[rnd], m),
                               jnp.asarray(n.numpy()))
        return torch.from_numpy(np.asarray(idx, np.int64))

    def kmeans_first(self, m):
        return int(jax.random.randint(jax.random.PRNGKey(self.seed + 1), (),
                                      0, m))


@pytest.fixture(scope="module")
def case():
    jfed = j_label_shift(jax.random.PRNGKey(0), n=N, m=M)
    kinit = jax.random.split(jax.random.PRNGKey(SEED))[1]
    params0 = jax.tree_util.tree_map(np.asarray, jax.jit(
        jlenet.init_params, static_argnums=1)(kinit, NARROW))
    fed = fed_from_numpy(*(np.asarray(a) for a in jfed), device="cpu")
    return jfed, params0, fed


@pytest.mark.parametrize("spec,streams", [("ucfl", M), ("ucfl_k2", 2),
                                          ("fedavg", 1)])
def test_run_federated_matches_reference(case, spec, streams):
    jfed, params0, fed = case
    want = j_run(spec, jfed, fl=JFLConfig(**FL_KW),
                 model_init=lambda k: jlenet.init_params(k, NARROW),
                 system=J_SYSTEMS["wireless_slow"], superstep=False,
                 keep_state=True, seed=SEED)
    got = run_federated(spec, fed, fl=FLConfig(**FL_KW),
                        model_init=lambda gen: tree_from_numpy(params0, "cpu"),
                        system=SYSTEMS["wireless_slow"], keep_state=True,
                        seed=SEED, draws=ReplayDraws(SEED, FL_KW["rounds"]),
                        device="cpu")
    assert got.rounds == want.rounds
    assert [tuple(c) for c in got.comm] == [tuple(c) for c in want.comm]
    assert got.comm[0] == (streams, 0)
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
    assert got.extra["comm_per_round"] == got.comm
    if spec.startswith("ucfl"):
        np.testing.assert_allclose(got.extras.mixing_matrix,
                                   want.extras.mixing_matrix, atol=1e-5)
        np.testing.assert_array_equal(got.extras.assignment,
                                      want.extras.assignment)


def test_default_draws_and_cpu_run_count_no_launches():
    fed = scenario_label_shift(1, n=200, m=3, device="cpu")
    before = dict(ops.LAUNCHES)
    h = run_federated("ucfl_k2", fed, fl=FLConfig(rounds=2, local_steps=1,
                                                  batch_size=4,
                                                  eval_every=1),
                      device="cpu")
    assert ops.LAUNCHES == before
    assert len(h.mean_acc) == 2 and np.all(np.isfinite(h.mean_acc))
    assert h.time == [0.0, 0.0]          # no system model: no clock


def test_torch_draws_follow_the_slot_rule():
    n = torch.tensor([3.0, 0.0, 50.0])
    idx = TorchDraws(7, "cpu").batch_indices(0, n, 40, 16, 5)
    assert idx.shape == (3, 5, 16) and idx.dtype == torch.int64
    assert int(idx[0].max()) < 3 and int(idx[1].max()) == 0
    assert int(idx[2].max()) < 40
    d1, d2 = TorchDraws(7, "cpu"), TorchDraws(7, "cpu")
    assert d1.kmeans_first(20) == d2.kmeans_first(20)
    assert torch.equal(d1.batch_indices(0, n, 40, 16, 5),
                       d2.batch_indices(0, n, 40, 16, 5))


def test_scenario_label_shift_keeps_the_padding_rule():
    fed = scenario_label_shift(0, n=600, m=5, device="cpu")
    m, n_max = fed.y.shape
    assert fed.x.shape == (m, n_max, 28, 28, 1)
    assert fed.x_val.shape[:2] == fed.y_val.shape and fed.y_val.shape[1] >= 4
    assert int(fed.n.max()) == n_max and int(fed.n.min()) >= 8
    for i in range(m):          # padded slots repeat the valid samples
        ni = int(fed.n[i])
        reps = -(-n_max // ni)
        tiled = fed.y[i, :ni].repeat(reps)[:n_max]
        assert torch.equal(fed.y[i], tiled)
    assert int(fed.y.max()) < 47 and torch.isfinite(fed.x).all()


def test_entry_points_refuse_what_this_slice_lacks():
    fed = scenario_label_shift(0, n=100, m=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_federated("fedavg", fed)
        with pytest.raises(RuntimeError, match="cuda"):
            scenario_label_shift(0, n=100, m=2)
    for kw in (dict(superstep=True), dict(channel="qsgd:4"),
               dict(faults="crash:0.1"), dict(sampler=object()),
               dict(async_cfg=object()), dict(min_quorum=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_federated("fedavg", fed, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown strategy"):
        run_federated("cfl", fed, device="cpu")


def test_port_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import repro_torch.fl, repro_torch.convert, chip_smoke\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
            "k.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
