"""The port's federated LM training CLI, `repro_torch.launch.train`, on
the CPU.

The reference CLI's registry and flag errors (`tests/test_placement.py`,
`tests/test_faults.py`) as parametrised cases, against the port's
`main`; the parse-time errors of every other registry-backed flag; then
`main` through every flag family the reference's has, on both
placements, at the cpu-small preset with tiny sizes (``--device cpu``):
each run's printed rounds and its return value, ``-mean_acc[-1]``, a
finite CE.  The checkpoint it writes restores in the reference's scanned
layout.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_train_state
from repro_torch.launch import train

TINY = ["--device", "cpu", "--clients", "4", "--pool", "6", "--seq", "16",
        "--batch", "2", "--steps", "2", "--eval-every", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("spec,match", [
    ("ucfl_k", "unknown strategy spec"),
    ("fedprox", "unknown strategy spec"),
    ("local_k2", "no _k parameter")])
def test_train_cli_bad_spec_raises_registry_error(spec, match):
    with pytest.raises(ValueError, match=match):
        train.main(["--algorithm", spec, "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--faults", "crash:2.0"],
    ["--faults", "gamma:0.1"],
    ["--robust-agg", "huber"],
    ["--robust-agg", "trimmed_mean:0.9"],
    ["--min-quorum", "0"],
    ["--max-retries", "-1"],
    ["--retry-backoff", "0"],
    ["--codec", "qsgd:0"],
    ["--edge-codec", "zip"],
    ["--link-profile", "tiered:x"],
    ["--cohort-schedule", "round_robin"],
    ["--edge-aggregator", "max"],
    ["--devices-per-user", "ragged:4-2"],
    ["--steps", "0"],
])
def test_train_cli_rejects_bad_flags(argv, capsys):
    with pytest.raises(SystemExit) as e:
        train.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert argv[0] in err


def test_train_cli_refuses_misplaced_knobs(capsys):
    for argv in (["--async", "--participation", "0.5"],
                 ["--cohort", "5"]):
        with pytest.raises(SystemExit) as e:
            train.main(TINY + argv)
        assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--steps", "1"])


RUNS = {
    "mesh": [],
    "host": ["--placement", "host"],
    "streams": ["--schedule", "shard_map_streams", "--algorithm", "ucfl"],
    "channel": ["--codec", "qsgd:8", "--link-profile", "tiered:4",
                "--system", "wireless_slow"],
    "topk": ["--placement", "host", "--codec", "topk:0.1",
             "--no-error-feedback"],
    "sampler": ["--participation", "0.5", "--algorithm", "fedavg"],
    "async": ["--async", "--buffer-k", "2", "--staleness-schedule", "poly"],
    "cohort": ["--cohort", "2", "--clients", "6", "--cohort-schedule",
               "random"],
    "hierarchy": ["--devices-per-user", "2", "--edge-codec", "qsgd:4",
                  "--edge-latency", "0.5"],
    "faults": ["--faults", "crash:0.2", "--robust-agg", "median",
               "--min-quorum", "1", "--placement", "host"],
}


@pytest.mark.parametrize("name", list(RUNS))
def test_train_cli_runs_every_flag_family(name, capsys):
    loss = train.main(TINY + RUNS[name])
    out = capsys.readouterr().out
    assert math.isfinite(loss) and 3.0 < loss < 10.0     # ~ln(512) = 6.2
    assert "round    1 loss/mean=" in out and "downlink total:" in out
    assert "params/model: 2.4M" in out
    if name in ("channel", "topk"):
        assert "channel: codec=" in out
    if name == "cohort":
        assert "paging: population=6 cohort=2" in out
    if name == "hierarchy":
        assert "hierarchy: fleets=" in out
    if name == "faults":
        assert "faults: spec=crash:0.2" in out


def test_train_cli_checkpoint_and_repeat(tmp_path, capsys):
    """The checkpoint holds the clients' params and momentum in the
    reference's scanned layout; a second identical call reuses the
    memoized loss functions (so the cached update step) and returns the
    same loss (to the CPU GEMMs' run-to-run rounding)."""
    path = str(tmp_path / "lm.ckpt")
    argv = TINY + ["--placement", "host", "--checkpoint", path]
    first = train.main(argv)
    hits = train._lm_fns.cache_info().hits
    assert train.main(argv) == pytest.approx(first, rel=1e-5)
    assert train._lm_fns.cache_info().hits == hits + 1
    step, params, opt, extra = restore_train_state(path, "cpu")
    assert step == 2 and extra == {"arch": "stablelm-3b-smoke",
                                   "algorithm": "ucfl_k2"}
    assert params["prefix_layers"] == [] and len(params["scan_layers"]) == 1
    assert params["embed"].shape == (4, 512, 256)
    assert opt["step"].tolist() == [2, 2, 2, 2]
    assert sorted(opt["mu"]) == sorted(params)
    assert np.isfinite(params["lm_head"].numpy()).all()
    assert "checkpoint written:" in capsys.readouterr().out
