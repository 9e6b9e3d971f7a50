"""Port LeNet-5 and SGD against the reference on the reference's params0.

Full-width LeNet-5 (28x28x1, 47 classes) on one batch made with numpy:
logits (atol 1e-5), loss, grads (rtol 1e-4 / atol 1e-6) and one
momentum-SGD step.  Both run float32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.models import lenet as jlenet
from repro.optim import apply_updates as j_apply, sgd as jsgd
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.models import lenet
from repro_torch.optim import apply_updates, sgd


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
    cfg = jlenet.LeNetConfig()
    params0 = jax.tree_util.tree_map(
        np.asarray, jax.jit(jlenet.init_params, static_argnums=1)(
            jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((16, 28, 28, 1)).astype(np.float32),
             "y": rng.integers(0, 47, 16).astype(np.int32)}
    return params0, batch


def _tbatch(batch):
    return {"x": torch.from_numpy(batch["x"]),
            "y": torch.from_numpy(batch["y"].astype(np.int64))}


def test_logits_and_loss_match(case):
    params0, batch = case
    p = tree_from_numpy(params0, "cpu")
    got = lenet.apply(p, torch.from_numpy(batch["x"]))
    want = jax.jit(jlenet.apply)(params0, jnp.asarray(batch["x"]))
    assert got.shape == (16, 47)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    loss, aux = lenet.loss_fn(p, _tbatch(batch))
    jloss, jaux = jax.jit(jlenet.loss_fn)(params0, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(aux["acc"]) == float(jaux["acc"])
    assert float(lenet.accuracy(p, _tbatch(batch))) == float(
        jaux["acc"])


def test_grads_and_sgd_step_match(case):
    params0, batch = case
    p = tree_from_numpy(params0, "cpu")
    g, _ = grad(lenet.loss_fn, has_aux=True)(p, _tbatch(batch))
    jg, _ = jax.jit(jax.grad(jlenet.loss_fn, has_aux=True))(params0, batch)
    jg = jax.tree_util.tree_map(np.asarray, jg)
    assert set(g) == set(jg)
    for k in jg:
        np.testing.assert_allclose(g[k].numpy(), jg[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    opt, jopt = sgd(0.1, momentum=0.9), jsgd(0.1, momentum=0.9)

    @jax.jit
    def jstep(params, state):
        upd, state = jopt.update(jg, state, params)
        return j_apply(params, upd), state

    state, jstate = opt.init(p), jopt.init(params0)
    for _ in range(2):      # second step exercises the momentum carry
        upd, state = opt.update(g, state, p)
        p = apply_updates(p, upd)
        params0, jstate = jstep(params0, jstate)
    assert int(state["step"]) == int(jstate["step"]) == 2
    got, want = tree_to_numpy(p), jax.tree_util.tree_map(np.asarray, params0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    got_mu = tree_to_numpy(state["mu"])
    for k in want:
        np.testing.assert_allclose(got_mu[k], np.asarray(jstate["mu"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_param_dtype_state_keeps_bf16(case):
    params0, _ = case
    p = {k: v.to(torch.bfloat16)
         for k, v in tree_from_numpy(params0, "cpu").items()}
    opt = sgd(0.1, momentum=0.9, state_dtype="param")
    state = opt.init(p)
    assert all(m.dtype == torch.bfloat16 for m in state["mu"].values())
    upd, state = opt.update(p, state, p)
    new = apply_updates(p, upd)
    assert all(v.dtype == torch.bfloat16 for v in new.values())
    assert all(m.dtype == torch.bfloat16 for m in state["mu"].values())


def test_init_params_shapes_match_reference():
    cfg = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
    want = jax.eval_shape(lambda k: jlenet.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    got = lenet.init_params(torch.Generator().manual_seed(0),
                            lenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12),
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
