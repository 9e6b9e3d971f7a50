"""The port's four examples against the reference's, on the CPU.

`examples/quickstart_torch.py` on the reference script's own datasets and
k-means first centre (the script run through `runpy`): W within 1e-6,
the assignment equal, both MSE lists within 1e-5, the silhouette within
1e-4 (both packages compute it from Gram-form distances in f32, whose
rounding on the diagonal differs between XLA's and PyTorch's products:
~1e-5 apart on the same W, which the test also checks).
`comm_tradeoff_torch.tradeoff` and
`personalization_emnist_torch.personalization` at a small size (m 4, n
300, 2 rounds, the narrow LeNet of `tests/test_torch_engine.py`) on the
port's covariate-shift arrays fed to both packages, the reference's key
chain replayed (`ReplayDraws`), against
`repro.fl.run_federated(..., superstep=False)` on the same arrays and
params0: streams, unicasts, round times and
downlink bits exactly, accuracies within one argmax flip (1/(m·n_val)),
the silhouettes within 1e-3 (`tests/test_torch_serve.py`'s tolerance,
for the same Gram-form rounding).  The examples import nothing of JAX or
of the reference package, and raise without a card unless asked for the
CPU.
"""
import ast
import contextlib
import io
import pathlib
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as j_kmeans
from repro.core import silhouette_score as j_silhouette
from repro.data.federated import FederatedData as JFederatedData
from repro.fl import Channel as JChannel
from repro.fl import FLConfig as JFLConfig
from repro.fl import SYSTEMS as J_SYSTEMS
from repro.fl import run_federated as j_run
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.core import silhouette_score
from repro_torch.data import scenario_covariate_shift
from repro_torch.fl import FLConfig, MeshShardMap
from repro_torch.models import lenet
from test_torch_engine import ReplayDraws

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import comm_tradeoff_torch as comm_ex  # noqa: E402
import personalization_emnist_torch as pers_ex  # noqa: E402
import quickstart_torch as quick_ex  # noqa: E402

EXAMPLES = ("quickstart", "comm_tradeoff", "personalization_emnist",
            "train_lm")
SEED, M, N = 0, 4, 300
FL_KW = dict(rounds=2, local_steps=2, batch_size=8, eval_every=1)
NARROW = lenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
COMM_SPECS = (("fedavg", 1), ("ucfl_k2", 2))
COMM_CODECS = ("identity", "qsgd:8", "topk:0.25")
KS = (2, 3)
PERS_SPECS = ("ucfl_k4", "oracle")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("stem", EXAMPLES)
def test_example_imports_no_jax(stem):
    tree = ast.parse((ROOT / "examples" / f"{stem}_torch.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "repro", "flax", "optax"}, mods
    assert "repro_torch" in mods


@pytest.mark.parametrize("module", [quick_ex, comm_ex, pers_ex],
                         ids=lambda m: m.__name__)
def test_example_needs_the_card_unless_asked(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])


@pytest.mark.parametrize("ret,code", [(None, 1), (0.5, 0)])
def test_train_lm_exit_code(ret, code, monkeypatch):
    import repro_torch.launch.train as train
    monkeypatch.setattr(train, "main", lambda: ret)
    with pytest.raises(SystemExit) as e:
        runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                       run_name="__main__")
    assert e.value.code == code


def test_quickstart_matches_reference():
    with contextlib.redirect_stdout(io.StringIO()):
        ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    datasets = [{k: np.array(v) for k, v in d.items()}
                for d in ref["datasets"]]
    first = int(jax.random.randint(ref["key"], (), 0, ref["m"]))
    got = quick_ex.quickstart(datasets, first=first, device="cpu")
    np.testing.assert_allclose(got["W"], np.asarray(ref["W"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["assignment"],
                                  np.asarray(ref["plan"].assignment))
    np.testing.assert_array_equal(got["groups"], np.asarray(ref["groups"]))
    want_sil = float(j_silhouette(ref["W"], ref["plan"].assignment, 2))
    assert abs(got["silhouette"] - want_sil) <= 1e-4
    # the same gap on the reference's own W: the distances' rounding
    same_w = float(silhouette_score(
        torch.from_numpy(np.array(ref["W"])),
        torch.from_numpy(np.array(ref["plan"].assignment)), 2))
    assert abs(same_w - want_sil) <= 1e-4
    for mine, theirs in (("mse_fedavg", "fedavg"), ("mse_ucfl", "ucfl")):
        np.testing.assert_allclose(got[mine],
                                   ref["client_mse"](ref[theirs]),
                                   rtol=0, atol=1e-5)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        quick_ex.print_report(got)
    assert "stream assignment: [0 0 0 1 0]  true groups: [0 0 0 1 1]" in \
        out.getvalue()


@pytest.fixture(scope="module")
def case():
    """The port's covariate-shift arrays (key 1, the comm sweep's) and
    the narrow LeNet's init, for both packages: one case for both
    sweeps."""
    fed = scenario_covariate_shift(1, n=N, m=M, device="cpu")
    jfed = JFederatedData(*(jnp.asarray(t.numpy()) for t in fed))
    params0 = tree_to_numpy(lenet.init_params(
        torch.Generator().manual_seed(SEED), NARROW, device="cpu"))
    return jfed, params0, fed


def _j_run(case, spec, **kw):
    jfed, params0, _ = case
    return j_run(spec, jfed, fl=JFLConfig(**FL_KW), seed=SEED,
                 model_init=lambda k: jax.tree_util.tree_map(jnp.asarray,
                                                             params0),
                 superstep=False, **kw)


def _port_kw(case):
    return dict(draws=lambda: ReplayDraws(SEED, FL_KW["rounds"]),
                model_init=lambda g: tree_from_numpy(case[1], "cpu"),
                device="cpu")


def _j_row(h):
    cost = h.comm[-1]
    bits = [c.dl_bits for c in h.comm_bits]
    return {"n_streams": cost.n_streams, "n_unicasts": cost.n_unicasts,
            "times": [s.round_time(M, n_streams=cost.n_streams,
                                   n_unicasts=cost.n_unicasts)
                      for s in J_SYSTEMS.values()],
            "dl_round": bits[-1] if bits else None,
            "dl_total": sum(bits) if bits else None}


def _same_row(got, h, flip, every_eval=False):
    assert {k: got[k] for k in ("n_streams", "n_unicasts", "times",
                                "dl_round", "dl_total")} == _j_row(h)
    jmean, jworst = h.mean_acc, h.worst_acc
    if every_eval:
        assert got["rounds"] == h.rounds
    else:
        jmean, jworst = jmean[-1], jworst[-1]
    np.testing.assert_allclose(got["mean_acc"], jmean, rtol=0,
                               atol=flip + 1e-6)
    np.testing.assert_allclose(got["worst_acc"], jworst, rtol=0,
                               atol=flip + 1e-6)


@pytest.fixture(scope="module")
def comm_runs(case):
    """(the port's sweep, the reference's runs by (spec, codec), its
    silhouettes)."""
    first = int(jax.random.randint(jax.random.PRNGKey(1), (), 0, M))
    got = comm_ex.tradeoff(case[2], FLConfig(**FL_KW), specs=COMM_SPECS,
                           codecs=COMM_CODECS, ks=KS, first=first,
                           **_port_kw(case))
    want = {(spec, "identity"): _j_run(case, spec, channel=JChannel())
            for spec, _ in COMM_SPECS}
    for codec in COMM_CODECS[1:]:
        want[(comm_ex.CODEC_SPEC, codec)] = _j_run(
            case, comm_ex.CODEC_SPEC, channel=JChannel(codec=codec))
    w = jnp.asarray(want[("ucfl_k2", "identity")].extras.mixing_matrix)
    sil = {}
    for k in KS:
        plan = j_kmeans(w, k, key=jax.random.PRNGKey(1))
        sil[k] = float(j_silhouette(w, plan.assignment, k))
    return got, want, sil


@pytest.mark.parametrize("spec,codec", [(s, "identity") for s, _ in
                                        COMM_SPECS]
                         + [("ucfl_k2", c) for c in COMM_CODECS[1:]])
def test_comm_tradeoff_matches_reference(spec, codec, comm_runs, case):
    got, want, _ = comm_runs
    row = (got["streams"][spec] if codec == "identity"
           else got["codecs"][codec])
    _same_row(row, want[(spec, codec)], 1.0 / (M * case[2].x_val.shape[1]))
    if codec == "identity" and spec == comm_ex.CODEC_SPEC:
        assert got["codecs"]["identity"] is row     # the sweep's own run


def test_comm_tradeoff_silhouettes_match_reference(comm_runs):
    got, _, want = comm_runs
    assert sorted(got["silhouette"]) == list(KS)
    for k in KS:
        assert abs(got["silhouette"][k] - want[k]) <= 1e-3, k
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        comm_ex.print_report(got, specs=COMM_SPECS)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("streams  mean_acc  worst_acc")
    assert [ln.split()[0] for ln in lines[1:3]] == ["1", "2"]


@pytest.fixture(scope="module")
def pers_runs(case):
    got = pers_ex.personalization(case[2], FLConfig(**FL_KW),
                                  specs=PERS_SPECS, **_port_kw(case))
    return got, {spec: _j_run(case, spec) for spec in PERS_SPECS}


@pytest.mark.parametrize("spec", PERS_SPECS)
def test_personalization_matches_reference(spec, pers_runs, case):
    got, want = pers_runs
    _same_row(got[spec], want[spec], 1.0 / (M * case[2].x_val.shape[1]),
              every_eval=True)
    assert got[spec]["dl_round"] is None          # no channel, no bits


def test_personalization_on_the_mesh_equals_host(pers_runs, case):
    """``--placement mesh``: `MeshShardMap` on a one-rank gloo group,
    bitwise the HostVmap sweep."""
    got = pers_ex.personalization(case[2], FLConfig(**FL_KW),
                                  specs=PERS_SPECS,
                                  placement=MeshShardMap(device="cpu"),
                                  **_port_kw(case))
    for spec in PERS_SPECS:
        assert got[spec]["mean_acc"] == pers_runs[0][spec]["mean_acc"]
        assert got[spec]["worst_acc"] == pers_runs[0][spec]["worst_acc"]
        assert got[spec]["history"].comm == pers_runs[0][spec]["history"].comm
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pers_ex.print_report(got)
    assert "of the oracle (4 true rotation groups)" in out.getvalue()
