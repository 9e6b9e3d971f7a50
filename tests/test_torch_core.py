"""Port UCFL setup math and aggregation against the reference.

The reference's label-shift scenario and a narrow LeNet's params0 go
through both packages as numpy: client gradients, Δ, σ² (rtol 1e-4),
the Eq. 6 mixing matrix W (atol 1e-5), the k-means `StreamPlan` from the
injected first centre (assignment equal), and the Eq. 5 mixes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import fedavg_weights as j_fedavg_weights
from repro.core import kmeans as jkmeans
from repro.core import mixing_matrix as j_mixing_matrix
from repro.core.similarity import delta_matrix as j_delta_matrix
from repro.core.similarity import flatten_pytree as j_flatten
from repro.core.streams import StreamPlan as JStreamPlan
from repro.data.federated import scenario_label_shift as j_label_shift
from repro.fl.stats import (full_client_gradients as j_grads,
                            sigma2_estimates as j_sigma2)
from repro.models import lenet as jlenet
from repro_torch.convert import fed_from_numpy, tree_from_numpy
from repro_torch.core import (StreamPlan, delta_matrix, fedavg_weights,
                              flatten_pytree, kmeans, mix_pytree,
                              mixing_matrix, stream_aggregate)
from repro_torch.fl.stats import full_client_gradients, sigma2_estimates
from repro_torch.models import lenet

SEED = 0
NARROW = jlenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)


@pytest.fixture(scope="module")
def setup():
    jfed = j_label_shift(jax.random.PRNGKey(0), n=400, m=6)
    params0 = jax.jit(jlenet.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), NARROW)
    ref = {
        "grads": jax.jit(j_grads, static_argnums=0)(jlenet.loss_fn, params0,
                                                    jfed),
        "sigma2": jax.jit(j_sigma2, static_argnums=(0, 3))(
            jlenet.loss_fn, params0, jfed, 5),
    }
    ref["delta"] = j_delta_matrix(ref["grads"])
    ref["w"] = j_mixing_matrix(ref["delta"], ref["sigma2"], jfed.n)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    fed = fed_from_numpy(*(np.asarray(a) for a in jfed), device="cpu")
    p0 = tree_from_numpy(jax.tree_util.tree_map(np.asarray, params0), "cpu")
    return jfed, params0, fed, p0, ref


def test_flatten_order_matches_tree_leaves(setup):
    _, params0, _, p0, _ = setup
    np.testing.assert_array_equal(flatten_pytree(p0).numpy(),
                                  np.asarray(j_flatten(params0)))


def test_delta_sigma2_and_w_match(setup):
    _, _, fed, p0, ref = setup
    grads = full_client_gradients(lenet.loss_fn, p0, fed)
    np.testing.assert_allclose(grads.numpy(), ref["grads"], rtol=1e-4,
                               atol=1e-6)
    delta = delta_matrix(grads)
    np.testing.assert_allclose(delta.numpy(), ref["delta"], rtol=1e-4,
                               atol=1e-5)
    sigma2 = sigma2_estimates(lenet.loss_fn, p0, fed, 5)
    np.testing.assert_allclose(sigma2.numpy(), ref["sigma2"], rtol=1e-4)
    w = mixing_matrix(delta, sigma2, fed.n)
    np.testing.assert_allclose(w.numpy(), ref["w"], atol=1e-5)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, atol=1e-6)


def test_fedavg_weights_match(setup):
    jfed, _, fed, _, _ = setup
    np.testing.assert_allclose(fedavg_weights(fed.n).numpy(),
                               np.asarray(j_fedavg_weights(jfed.n)),
                               atol=1e-7)


@pytest.mark.parametrize("k", [2, 3])
def test_stream_plan_matches_with_injected_first_centre(setup, k):
    _, _, _, _, ref = setup
    m = ref["w"].shape[0]
    key = jax.random.PRNGKey(SEED + 1)           # what UCFL.setup uses
    first = int(jax.random.randint(key, (), 0, m))
    want = jax.jit(jkmeans, static_argnums=1)(jnp.asarray(ref["w"]), k,
                                              key=key)
    got = kmeans(torch.tensor(ref["w"]), k, first=first)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixes_match(setup, dtype):
    _, params0, _, _, ref = setup
    m = ref["w"].shape[0]
    rng = np.random.default_rng(5)
    stacked = {k: rng.standard_normal((m,) + v.shape).astype(np.float32)
               for k, v in params0.items()}
    jst = {k: jnp.asarray(v).astype(jnp.dtype(dtype))
           for k, v in stacked.items()}
    tst = {k: torch.from_numpy(v).to(getattr(torch, dtype))
           for k, v in stacked.items()}
    tol = 1e-5 if dtype == "float32" else 2e-2
    w = ref["w"]
    got = mix_pytree(tst, torch.tensor(w))
    want = jax.jit(jagg.mix_pytree)(jst, jnp.asarray(w))
    plan = jax.jit(jkmeans, static_argnums=1)(jnp.asarray(w), 2,
                                              key=jax.random.PRNGKey(1))
    tplan = StreamPlan(torch.tensor(np.asarray(plan.centroids)),
                       torch.tensor(np.asarray(plan.assignment, np.int64)),
                       torch.tensor(0.0))
    got_s = stream_aggregate(tst, tplan)
    want_s = jax.jit(jagg.stream_aggregate)(jst, JStreamPlan(*plan))
    for a, b in ((got, want), (got_s, want_s)):
        for name in b:
            assert a[name].dtype == getattr(torch, dtype)
            assert tuple(a[name].shape) == b[name].shape
            np.testing.assert_allclose(a[name].float().numpy(),
                                       np.asarray(b[name], np.float32),
                                       rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_folded_stream_aggregate_matches_reference(setup, k):
    """`stream_aggregate` mixes once with centroids[assignment] (m, m); it
    matches the reference's mix-then-gather at f32's 1e-5, and on the CPU
    the gather form of the port's own mix within the same tolerance."""
    _, params0, _, _, ref = setup
    m = ref["w"].shape[0]
    rng = np.random.default_rng(11 + k)
    stacked = {n: rng.standard_normal((m,) + v.shape).astype(np.float32)
               for n, v in params0.items()}
    plan = jax.jit(jkmeans, static_argnums=1)(jnp.asarray(ref["w"]), k,
                                              key=jax.random.PRNGKey(k))
    tplan = StreamPlan(torch.tensor(np.asarray(plan.centroids)),
                       torch.tensor(np.asarray(plan.assignment, np.int64)),
                       torch.tensor(0.0))
    tst = {n: torch.from_numpy(v) for n, v in stacked.items()}
    got = stream_aggregate(tst, tplan)
    want = jax.jit(jagg.stream_aggregate)(
        {n: jnp.asarray(v) for n, v in stacked.items()}, JStreamPlan(*plan))
    gathered = {n: v[tplan.assignment]
                for n, v in mix_pytree(tst, tplan.centroids).items()}
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(),
                                   gathered[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
