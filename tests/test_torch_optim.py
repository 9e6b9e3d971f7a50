"""The port's optimizers, schedules and clipping against `repro.optim`.

`sgd` (momentum, Nesterov, weight decay, a schedule as the rate, f32 or
param-dtype momentum), `adamw`, the three schedules, `global_norm` and
`clip_by_global_norm`, each run by both packages on the same numpy trees
for a few steps.  The port's update is elementwise over dicts, so it also
runs on a client-stacked dict (`init_stacked`, a per-client step counter
and schedule rate) and must equal the per-client runs.  Values at rtol
1e-6 / atol 1e-7 (XLA and torch may round a transcendental differently
by an ulp); the bf16 param-dtype run bitwise.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro_torch import optim as topt
from repro_torch.convert import tree_from_numpy, tree_to_numpy

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": rng.standard_normal((5,)).astype(dtype)}


def _close(got, want, rtol=RTOL, atol=ATOL):
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float32),
                                   np.asarray(v, np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)


def _run(jo, to, steps=4, dtype=np.float32):
    """Both packages' optimizer over ``steps`` steps from the same params
    and gradients; returns (reference params, port params, both states)."""
    jp = {k: jnp.asarray(v) for k, v in _tree(0, dtype).items()}
    tp = tree_from_numpy(_tree(0, dtype), "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for s in range(steps):
        g = _tree(10 + s, dtype)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tree_from_numpy(g, "cpu"), ts, tp)
        tp = topt.apply_updates(tp, tu)
    return ({k: np.asarray(v) for k, v in jp.items()}, tree_to_numpy(tp),
            js, ts)


SGD_CASES = [
    dict(lr=0.1),
    dict(lr=0.1, momentum=0.9),
    dict(lr=0.05, momentum=0.9, nesterov=True),
    dict(lr=0.1, momentum=0.8, weight_decay=0.01),
    dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.05),
    dict(lr=0.1, weight_decay=0.1),
]


@pytest.mark.parametrize("kw", SGD_CASES)
def test_sgd_matches_reference(kw):
    jp, tp, js, ts = _run(jopt.sgd(**kw), topt.sgd(**kw))
    _close(tp, jp)
    assert int(ts["step"]) == int(js["step"]) == 4
    if kw.get("momentum"):
        _close(tree_to_numpy(ts["mu"]), js["mu"])
    else:
        assert ts["mu"] is None and js["mu"] is None


@pytest.mark.parametrize("sched", ["constant", "cosine", "warmup"])
def test_sgd_with_a_schedule_matches_reference(sched):
    make = {"constant": lambda m: m.constant(0.07),
            "cosine": lambda m: m.cosine_decay(0.2, 6, 0.1),
            "warmup": lambda m: m.warmup_cosine(0.2, 2, 8)}[sched]
    kw = dict(momentum=0.9, nesterov=True, weight_decay=0.01)
    jp, tp, _, _ = _run(jopt.sgd(make(jopt), **kw),
                        topt.sgd(make(topt), **kw), steps=6)
    _close(tp, jp)


def test_sgd_param_dtype_state_matches_reference():
    kw = dict(lr=0.1, momentum=0.9, state_dtype="param")
    jp, tp, js, ts = _run(jopt.sgd(**kw), topt.sgd(**kw),
                          dtype=ml_dtypes.bfloat16)
    for k in jp:
        assert tp[k].dtype == jp[k].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert ts["mu"]["a"].dtype == torch.bfloat16


@pytest.mark.parametrize("kw", [dict(lr=1e-2),
                                dict(lr=3e-3, weight_decay=0.0),
                                dict(lr=1e-2, b1=0.8, b2=0.99, eps=1e-6)])
def test_adamw_matches_reference(kw):
    jp, tp, js, ts = _run(jopt.adamw(**kw), topt.adamw(**kw), steps=5)
    _close(tp, jp, rtol=1e-5, atol=1e-6)
    _close(tree_to_numpy(ts["m"]), js["m"])
    _close(tree_to_numpy(ts["v"]), js["v"])
    assert ts["m"]["a"].dtype == torch.float32


def test_adamw_with_a_schedule_matches_reference():
    jp, tp, _, _ = _run(jopt.adamw(jopt.warmup_cosine(1e-2, 2, 6)),
                        topt.adamw(topt.warmup_cosine(1e-2, 2, 6)), steps=6)
    _close(tp, jp, rtol=1e-5, atol=1e-6)


def test_schedules_match_reference():
    steps = np.arange(0, 12, dtype=np.int32)
    for jf, tf in ((jopt.constant(0.3), topt.constant(0.3)),
                   (jopt.cosine_decay(1.0, 10, 0.1),
                    topt.cosine_decay(1.0, 10, 0.1)),
                   (jopt.warmup_cosine(1.0, 3, 10),
                    topt.warmup_cosine(1.0, 3, 10)),
                   (jopt.warmup_cosine(0.5, 0, 4),
                    topt.warmup_cosine(0.5, 0, 4))):
        want = np.array([float(jf(jnp.asarray(s))) for s in steps])
        got = tf(torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(3)
    want, wnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, norm = topt.clip_by_global_norm(tree_from_numpy(g, "cpu"), max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=RTOL)
    np.testing.assert_allclose(float(topt.global_norm(
        tree_from_numpy(g, "cpu"))), float(jopt.global_norm(g)), rtol=RTOL)
    _close(tree_to_numpy(got), want)
    if max_norm < 1:
        assert float(topt.global_norm(got)) == pytest.approx(max_norm,
                                                             rel=1e-5)
    bf = tree_from_numpy(_tree(3, ml_dtypes.bfloat16), "cpu")
    out, _ = topt.clip_by_global_norm(bf, max_norm)
    assert out["a"].dtype == torch.float32     # f32 scale, as jnp promotes


@pytest.mark.parametrize("make", [
    lambda: topt.sgd(topt.cosine_decay(0.2, 5), momentum=0.9,
                     nesterov=True, weight_decay=0.01),
    lambda: topt.adamw(topt.warmup_cosine(1e-2, 1, 5))])
def test_stacked_update_is_the_per_client_update(make):
    """A client-stacked dict with a per-client step counter (one client a
    step behind) updates each row as that client's own run does."""
    opt = make()
    m = 3
    stacked = tree_from_numpy({k: np.stack([v] * m) for k, v in
                               _tree(0).items()}, "cpu")
    state = opt.init_stacked(stacked, m)
    state["step"] = torch.tensor([0, 1, 0], dtype=torch.int32)
    singles = [{k: v[i].clone() for k, v in stacked.items()}
               for i in range(m)]
    sstates = [opt.init(p) for p in singles]
    sstates[1]["step"] = torch.tensor(1, dtype=torch.int32)
    for s in range(3):
        g = {k: np.stack([v * (i + 1) for i in range(m)])
             for k, v in _tree(20 + s).items()}
        u, state = opt.update(tree_from_numpy(g, "cpu"), state, stacked)
        stacked = topt.apply_updates(stacked, u)
        for i in range(m):
            ui, sstates[i] = opt.update(
                {k: torch.from_numpy(v[i]) for k, v in g.items()},
                sstates[i], singles[i])
            singles[i] = topt.apply_updates(singles[i], ui)
    for i in range(m):
        for k in stacked:
            assert torch.equal(stacked[k][i], singles[i][k]), (i, k)
