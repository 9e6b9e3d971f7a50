"""The reference's public surface, in the port, on the CPU.

Every name of every ``__all__`` in `src/repro/**/__init__.py` resolves in
the port's counterpart package and stands in its ``__all__`` (one name
kept out, `EXCLUDED`, with its reason); `downlink_cost` (the function and
each family's classmethod) equals the reference's over every registered
family, and each strategy's per-run `comm` agrees with it; `all_configs`
has the reference's keys; `make_client_update` takes the reference's
minibatches and lands within the engine tests' tolerances of the
reference's step; `build_fleet_update` builds the step
`cached_fleet_update` builds; and the planner's ``--skip-existing`` skips
a case whose artifact exists, as the reference's does.
"""
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.fl import downlink_cost as j_downlink_cost
from repro.fl import get_strategy_class as j_strategy_class
from repro.fl.placement.host import make_client_update as j_make_update
from repro.models import lenet as jlenet
from repro.optim import sgd as j_sgd
from repro_torch import configs
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.data import scenario_label_shift
from repro_torch.fl import (FLConfig, HierarchyConfig, available_strategies,
                            downlink_cost, get_strategy_class, run_federated)
from repro_torch.fl.hierarchy import (FleetUpdate, build_fleet_update,
                                      cached_fleet_update, fleet_plan)
from repro_torch.fl.placement import ClientUpdate, make_client_update
from repro_torch.fl.placement.host import cached_update
from repro_torch.launch import dryrun
from repro_torch.models import lenet
from repro_torch.optim import sgd
from test_torch_engine import ReplayDraws

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXCLUDED = {
    # parses XLA's HLO text; the port has no compiler and counts the
    # collectives a case issues on meta tensors (roofline/analysis.py)
    ("repro.roofline", "parse_collective_bytes"),
}
# the reference's packages that declare a public surface
PACKAGES = sorted(".".join(p.parent.relative_to(ROOT / "src").parts)
                  for p in (ROOT / "src" / "repro").rglob("__init__.py")
                  if "__all__" in p.read_text())
SPECS = sorted(available_strategies()) + ["ucfl_k2", "ucfl_k7"]
NARROW = lenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("package", PACKAGES)
def test_public_surface_resolves(package):
    names = importlib.import_module(package).__all__
    port = importlib.import_module(package.replace("repro", "repro_torch", 1))
    want = [n for n in names if (package, n) not in EXCLUDED]
    assert [n for n in want if not hasattr(port, n)] == []
    assert [n for n in want if n not in port.__all__] == []
    for pkg, name in EXCLUDED:
        if pkg == package:
            assert name in names and not hasattr(port, name)


@pytest.mark.parametrize("spec", SPECS)
def test_downlink_cost_matches_reference(spec):
    for m in (4, 12, 40):
        for n_streams in (1, 2, 4):
            for cand in (3, 5):
                want = j_downlink_cost(spec, m, n_streams, cand)
                assert downlink_cost(spec, m, n_streams, cand) == want
                got = get_strategy_class(spec).downlink_cost(
                    m, n_streams=n_streams, fomo_candidates=cand)
                assert tuple(got) == tuple(j_strategy_class(spec)
                                           .downlink_cost(
                                               m, n_streams=n_streams,
                                               fomo_candidates=cand))
    assert downlink_cost(spec, 12) == j_downlink_cost(spec, 12)


@pytest.mark.parametrize("spec", ["nope", "fedavg_k2", "ucfl_kx"])
def test_downlink_cost_unknown_spec_raises(spec):
    with pytest.raises(ValueError) as want:
        j_downlink_cost(spec, 4)
    with pytest.raises(ValueError) as got:
        downlink_cost(spec, 4)
    assert str(got.value) == str(want.value)


def test_base_downlink_cost_is_abstract():
    from repro_torch.fl.strategies import Strategy
    with pytest.raises(NotImplementedError):
        Strategy.downlink_cost(4)


@pytest.fixture(scope="module")
def small_fed():
    return scenario_label_shift(0, n=160, m=4, device="cpu")


@pytest.mark.parametrize("spec", SPECS)
def test_comm_agrees_with_downlink_cost(spec, small_fed):
    """A run's `History.comm` is the table's entry for its m, with the
    streams its state transmits (the clusters, groups or k-means
    centres) and the run's FLConfig candidates."""
    fl = FLConfig(rounds=2, local_steps=1, batch_size=4, eval_every=1,
                  fomo_candidates=3, cfl_min_rounds=1)
    h = run_federated(spec, small_fed, fl=fl, seed=0, device="cpu",
                      model_init=lambda g: lenet.init_params(g, NARROW,
                                                             device="cpu"))
    m = small_fed.m
    streams = {"fedavg": 1, "local": 1, "fedfomo": 1, "ucfl": m,
               "ucfl_k2": 2, "ucfl_k7": m,
               "oracle": len(np.unique(small_fed.group.numpy()))}
    if spec == "cfl":
        streams["cfl"] = int(h.extras.clusters.max()) + 1
    want = downlink_cost(spec, m, n_streams=streams[spec],
                         fomo_candidates=fl.fomo_candidates)
    assert tuple(h.comm[-1]) == want
    assert tuple(h.comm[-1]) == j_downlink_cost(
        spec, m, streams[spec], fl.fomo_candidates)


def test_all_configs_match_reference():
    got, want = configs.all_configs(), jconfigs.all_configs()
    assert sorted(got) == sorted(want)
    for arch, cfg in got.items():
        assert cfg is configs.get_config(arch)
        assert cfg.name == want[arch].name
        assert cfg.d_model == want[arch].d_model
        assert cfg.n_layers == want[arch].n_layers


def test_make_client_update_matches_reference():
    """The factory's step on the reference's minibatch slots (its key
    chain replayed) against the reference's per-client step vmapped over
    the same keys: params within rtol 1e-4 / atol 1e-5."""
    m, n_slots = 3, 40
    fl = FLConfig(local_steps=2, batch_size=8)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, n_slots, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, (m, n_slots)).astype(np.int32)
    n = np.array([40, 25, 33], np.int32)
    params0 = tree_to_numpy(lenet.init_params(
        torch.Generator().manual_seed(3), NARROW, device="cpu"))
    jstack = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (m,) + a.shape), params0)
    jopt = j_sgd(fl.lr, momentum=fl.momentum)
    jstep = j_make_update(jlenet.loss_fn, jopt, fl)
    draws = ReplayDraws(0, 1)
    want, _ = jax.jit(jax.vmap(jstep))(jstack, jax.vmap(jopt.init)(jstack),
                              jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(n),
                              jax.random.split(draws.krounds[0], m))

    opt = sgd(fl.lr, momentum=fl.momentum)
    step = make_client_update(lenet.loss_fn, opt, fl)
    assert isinstance(step, ClientUpdate)
    stacked = {k: v.expand((m,) + v.shape).clone()
               for k, v in tree_from_numpy(params0, "cpu").items()}
    tx, ty, tn = (torch.from_numpy(a) for a in (x, y.astype(np.int64), n))
    idx = step.draw(draws, 0, tx, tn)
    got, _ = step(stacked, opt.init_stacked(stacked, m), tx, ty, tn, idx)
    # the cached step is the same factory's
    _, cached = cached_update(lenet.loss_fn, fl.local_steps, fl.batch_size,
                              fl.lr, fl.momentum)
    again, _ = cached(stacked, opt.init_stacked(stacked, m), tx, ty, tn, idx)
    gp = tree_to_numpy(got)
    for k, v in want.items():
        np.testing.assert_allclose(gp[k], np.asarray(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        assert torch.equal(got[k], again[k]), k


def test_build_fleet_update_is_the_engines_step():
    fl = FLConfig(local_steps=2, batch_size=8)
    params0 = lenet.init_params(torch.Generator().manual_seed(0), NARROW,
                                device="cpu")
    plan = fleet_plan(HierarchyConfig(devices_per_user=2,
                                      edge_codec="qsgd:4"), 4, params0, None)
    opt = sgd(fl.lr, momentum=fl.momentum)
    step = build_fleet_update(plan, make_client_update(lenet.loss_fn, opt,
                                                       fl),
                              backend="pallas", donate=True)
    _, cached = cached_fleet_update(lenet.loss_fn, fl.local_steps,
                                    fl.batch_size, fl.lr, fl.momentum, None,
                                    plan)
    assert isinstance(step, FleetUpdate)
    for attr in ("plan", "codec", "backend", "agg", "edge_hook",
                 "shortcut"):
        assert getattr(step, attr) == getattr(cached, attr), attr
    assert not step.shortcut


def test_dryrun_skip_existing(tmp_path, monkeypatch, capsys):
    """A case whose artifact is under --out is reported and not planned;
    without the flag, or for a case with no artifact, it is planned."""
    planned = []
    monkeypatch.setattr(dryrun, "run_case",
                        lambda a, s, **kw: planned.append((a, s)))
    mesh = dryrun.make_card_mesh("meta")
    done = tmp_path / dryrun.mesh_name(mesh) / "gemma-2b__decode_32k.json"
    done.parent.mkdir(parents=True)
    done.write_text("{}")
    base = ["--device", "meta", "--out", str(tmp_path)]
    for shape in ("decode_32k", "prefill_32k"):
        assert dryrun.main(["--arch", "gemma-2b", "--shape", shape,
                            "--skip-existing"] + base) == 0
    assert planned == [("gemma-2b", "prefill_32k")]
    assert "skip gemma-2b x decode_32k (artifact exists)" in \
        capsys.readouterr().out
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k"]
                       + base) == 0
    assert planned[-1] == ("gemma-2b", "decode_32k")
