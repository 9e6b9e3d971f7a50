"""Port kernel ops against the reference's Pallas kernels.

On the CPU the port's ops run their plain versions (`repro_torch.kernels.
ref`) and the reference's run its Pallas kernels in interpret mode; the
same numpy inputs go through both.  Tolerances are
`tests/test_kernels.py`'s: f32 1e-5, bf16 2e-2, Δ rtol 1e-4 / atol 1e-2.
The CUDA kernels are held against the plain versions on the card in
`tests/test_torch_gpu.py` and by `chip_smoke.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pairwise_sqdist import TD, chunking

RNG = np.random.default_rng(0)


def _rows(k, m, rng):
    w = rng.uniform(size=(k, m)).astype(np.float32)
    return w / w.sum(1, keepdims=True)


def _to_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("k,m,d", [(1, 20, 777), (4, 20, 2048),
                                   (20, 20, 4096 + 13), (7, 3, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixing_aggregate_matches_pallas(k, m, d, dtype):
    rng = np.random.default_rng(k * 31 + m)
    w = _rows(k, m, rng)
    theta = rng.standard_normal((m, d)).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    theta_t = torch.from_numpy(theta).to(tdt)
    got = ops.mixing_aggregate(torch.from_numpy(w), theta_t)
    assert got.dtype == tdt and got.shape == (k, d)
    want = jops.mixing_aggregate(jnp.asarray(w),
                                 jnp.asarray(theta).astype(jnp.dtype(dtype)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=tol, atol=tol)


def test_mixing_aggregate_identity():
    theta = torch.from_numpy(RNG.standard_normal((8, 512)).astype(np.float32))
    got = ops.mixing_aggregate(torch.eye(8), theta)
    np.testing.assert_allclose(got.numpy(), theta.numpy(), atol=1e-6)


@pytest.mark.parametrize("m,d", [(2, 128), (7, 1000), (20, 5000)])
def test_pairwise_sqdist_and_gram_match_pallas(m, d):
    g = np.random.default_rng(m * 7 + d).standard_normal((m, d)).astype(
        np.float32)
    gt = torch.from_numpy(g)
    np.testing.assert_allclose(ops.gram_matrix(gt).numpy(),
                               np.asarray(jops.gram_matrix(jnp.asarray(g))),
                               rtol=1e-4, atol=1e-2)
    got = ops.pairwise_sqdist(gt).numpy()
    np.testing.assert_allclose(got,
                               np.asarray(jops.pairwise_sqdist(jnp.asarray(g))),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, ref.pairwise_sqdist_ref(gt).numpy(),
                               rtol=1e-4, atol=1e-2)


def test_pairwise_sqdist_properties():
    d = ops.pairwise_sqdist(
        torch.from_numpy(RNG.standard_normal((10, 333)).astype(np.float32)))
    d = d.numpy()
    assert np.all(np.diag(d) == 0.0)
    np.testing.assert_array_equal(d, d.T)
    assert (d >= 0).all()


def test_cpu_ops_do_not_count_launches():
    before = dict(ops.LAUNCHES)
    ops.mixing_aggregate(torch.ones(2, 3), torch.ones(3, 5))
    ops.pairwise_sqdist(torch.ones(3, 5))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("m,d", [(1, 1), (20, 47571), (100, 47571),
                                 (3, 10 ** 8)])
def test_gram_chunking_covers_d(m, d):
    chunk, nchunks = chunking(m, d)
    assert chunk % TD == 0 and 1 <= nchunks <= 65535
    assert (nchunks - 1) * chunk < d <= nchunks * chunk
