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
from repro_torch.fl import (FLConfig, MeshShardMap, SYSTEMS, TorchDraws,
                            run_federated)
from repro_torch.fl.draws import FaultDraws
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
M, N = 4, 300
FL_KW = dict(rounds=3, local_steps=2, batch_size=8, eval_every=1)
NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)


class ReplayDraws:
    """The reference engine's draws, replayed from its key chain:
    PRNGKey(seed) -> split -> (key, kinit); per round key, ksample =
    split(key) when a key-spending sampler is on (``sampler_keys``), then
    key, kround = split(key), ckeys = split(kround, m); per client
    split(ckey, S); per step randint(k, (B,), 0, 2**30) % max(n_i, 1) %
    n_slots.  The k-means start is randint(PRNGKey(seed + 1), (), 0, m),
    a sampler's order permutation(ksample, m), the codec noise
    uniform(fold_in(kround, 2), (m, D)), and a faulted run's draws
    fold_in(kfault, i) of kfault = fold_in(kround, 3): i = 0 the crash
    row, 1 the NaN row, 2 the bit-rot row (bernoulli, (m,)), 3 the bit-rot
    element mask (bernoulli, (m, D)), 4 the flipped bit (randint in
    [0, 32), int32, (m, D)).  A hierarchy run's device slots are
    vmap(split(ckey_i, d_max)), then each device's split(·, S) and the
    slot rule over its own n_id; its edge codec noise is
    uniform(fold_in(ckeys[row], 0x65646765), shape) of the update's first
    row, and its device-dropout coins bernoulli(fold_in(ekey, 1), 1 - p,
    shape) of that edge key ekey."""

    def __init__(self, seed, rounds, sampler_keys=False):
        key = jax.random.PRNGKey(seed)
        key, _ = jax.random.split(key)
        self.krounds, self.ksamples = [], []
        for _ in range(rounds):
            if sampler_keys:
                key, ksample = jax.random.split(key)
                self.ksamples.append(ksample)
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

    def permutation(self, rnd, m):
        return torch.from_numpy(np.asarray(
            jax.random.permutation(self.ksamples[rnd], m), np.int64))

    def codec_noise(self, rnd, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(self.krounds[rnd], 2), tuple(shape),
            jnp.float32)))

    def fault_draws(self, rnd, m, d, cfg):
        kfault = jax.random.fold_in(self.krounds[rnd], 3)

        def bern(i, p, shape):
            return torch.from_numpy(np.array(jax.random.bernoulli(
                jax.random.fold_in(kfault, i), p, shape)))

        crash = bern(0, cfg.crash, (m,)) if cfg.crash > 0 else None
        nan = bern(1, cfg.nan, (m,)) if cfg.nan > 0 else None
        rot = elem = bit = None
        if cfg.bitrot > 0:
            rot = bern(2, cfg.bitrot, (m,))
            elem = bern(3, cfg.bitrot_density, (m, d))
            bit = torch.from_numpy(np.array(jax.random.randint(
                jax.random.fold_in(kfault, 4), (m, d), 0, 32,
                dtype=jnp.int32)))
        return FaultDraws(crash, nan, rot, elem, bit)

    def device_batch_indices(self, rnd, n, n_slots, batch_size,
                             local_steps):
        m, d_max = n.shape

        def device(dkey, n_id):
            keys = jax.random.split(dkey, local_steps)
            r = jax.vmap(lambda k: jax.random.randint(
                k, (batch_size,), 0, 1 << 30))(keys)
            return r % jnp.maximum(n_id.astype(jnp.int32), 1) % n_slots

        dkeys = jax.vmap(lambda k: jax.random.split(k, d_max))(
            jax.random.split(self.krounds[rnd], m))
        idx = jax.vmap(jax.vmap(device))(dkeys, jnp.asarray(n.numpy()))
        return torch.from_numpy(np.asarray(idx, np.int64))

    def _edge_key(self, rnd, m, row):
        return jax.random.fold_in(jax.random.split(self.krounds[rnd], m)[row],
                                  0x65646765)

    def edge_noise(self, rnd, m, row, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            self._edge_key(rnd, m, row), tuple(shape), jnp.float32)))

    def device_dropout(self, rnd, m, row, shape, p):
        return torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(self._edge_key(rnd, m, row), 1), 1.0 - p,
            tuple(shape))))


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
    with pytest.raises(TypeError, match="cannot resolve hierarchy"):
        run_federated("fedavg", fed, device="cpu", hierarchy=object())
    fl = FLConfig(rounds=1, local_steps=1, batch_size=4, eval_every=1)
    h = run_federated("fedavg", fed, fl=fl, device="cpu", hierarchy=2)
    assert h.extra["hierarchy"]["d_max"] == 2 and np.isfinite(h.mean_acc).all()
    for spec, streams in (("local", 0), ("oracle", 1)):
        h = run_federated(spec, fed, fl=fl, device="cpu")
        assert h.comm == [(streams, 0)] and np.isfinite(h.mean_acc).all()
    with pytest.raises(ValueError, match="unknown strategy"):
        run_federated("nope", fed, device="cpu")
    # the mesh placement (ROADMAP item 15) is ported: it runs, and it
    # refuses what the reference refuses
    h = run_federated("fedavg", fed, fl=fl, device="cpu",
                      placement=MeshShardMap(device="cpu"))
    assert h.comm == [(1, 0)] and np.isfinite(h.mean_acc).all()
    with pytest.raises(ValueError, match="unknown mixing schedule"):
        MeshShardMap(schedule="ring", device="cpu")
    # --federated is ported (tests/test_torch_serve_lm.py) for every
    # family; on whisper both CLIs refuse with the same `KeyError`: its
    # loss needs audio frames, and the LM clients hold tokens only
    from repro.launch import serve as j_serve_cli
    small = ["--federated", "--arch", "whisper-tiny", "--rounds", "1",
             "--clients", "2", "--pool", "5", "--requests", "1",
             "--tokens", "2", "--prompt-len", "8"]
    with pytest.raises(KeyError, match="audio_embeds"):
        j_serve_cli.main(small)
    with pytest.raises(KeyError, match="audio_embeds") as err:
        serve_cli.main(small + ["--device", "cpu"])
    assert "item 15" not in str(err.value)


def test_port_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import repro_torch.fl, repro_torch.fl.channel, "
            "repro_torch.fl.faults, repro_torch.fl.runtime, "
            "repro_torch.fl.serve, repro_torch.fl.population, "
            "repro_torch.fl.hierarchy, "
            "repro_torch.core, repro_torch.launch.dryrun, "
            "repro_torch.roofline, "
            "repro_torch.checkpoint, repro_torch.convert, chip_smoke\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
            "k.startswith(('repro.', 'msgpack'))]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
