"""The top-k threshold kernel's multi-level walk, on the CPU.

`kernels.ref.topk_threshold_tree_ref` repeats the CUDA kernel's
arithmetic (``csrc/topk_threshold.cu``: the 30 bisection steps taken
``levels`` at a time, every candidate of a pass counted in one pass over
the row, then a walk down the tree).  Each case holds it BITWISE against
the sequential plain version (`ref.topk_threshold_ref`) and against the
reference's Pallas kernel in interpret mode, at levels 1, 2, 3 (the
kernel's) and 5, for k = 1, k = D and k = D + 1 among others, on rows
that are all zero, hold a NaN, tie at the k-th value or are denormal, and
at widths the kernel's cluster of 8 blocks cannot split evenly, and on
rows whose midpoints overflow to inf or that hold inf.  XLA's CPU
backend treats denormals as zero, while the CUDA kernel and PyTorch on the
CPU do not: the Pallas kernel is held against the walk on the inputs with
denormals flushed to zero, the sequential version on the inputs as they
are.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels.topk_threshold import CLUSTER, LEVELS

TINY = np.float32(np.finfo(np.float32).tiny)   # the smallest normal f32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs: PyTorch's intra-op threads only contend with the other
    test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(name: str) -> np.ndarray:
    """(m, D) float32 magnitudes of one case, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        return np.abs(rng.standard_normal((5, 777))).astype(np.float32)
    if name == "zero_and_nan_rows":
        x = np.abs(rng.standard_normal((4, 300))).astype(np.float32)
        x[1] = 0.0
        x[2, 123] = np.nan
        return x
    if name == "ties":
        # a handful of distinct values: the k-th value is tied for most k
        vals = np.array([0.0, 0.5, 1.0, 2.0, 3.0], np.float32)
        return vals[rng.integers(0, len(vals), (3, 500))]
    if name == "denormals":
        x = (rng.uniform(size=(3, 400)) * TINY).astype(np.float32)
        x[1, ::7] = 0.0
        x[2, ::3] = np.abs(rng.standard_normal(134)).astype(np.float32)
        return x
    if name == "ragged_slices":
        # D = 6,157: a slice of 770 a block, the last block's 767
        return np.abs(rng.standard_normal((2, 8 * 256 * 3 + 13))).astype(
            np.float32)
    if name == "huge_and_inf":
        # midpoints that overflow to inf, and a row holding inf
        x = (np.minimum(np.abs(rng.standard_normal((3, 500))), 6.0)
             * 5e37).astype(np.float32)
        x[1, ::50] = np.inf
        x[2] = np.abs(rng.standard_normal(500)).astype(np.float32)
        x[2, 7] = np.inf
        return x
    if name == "fewer_values_than_blocks":
        # D = 9: slices of 2, the fifth block's 1, the last three empty
        return np.abs(rng.standard_normal((3, 9))).astype(np.float32)
    raise ValueError(name)


CASES = ["random", "zero_and_nan_rows", "ties", "denormals", "ragged_slices",
         "fewer_values_than_blocks", "huge_and_inf"]
_PALLAS = {}


def _pallas(name: str, x: np.ndarray, k: int) -> np.ndarray:
    """The Pallas kernel's thresholds, once per (case, k) for all levels."""
    if (name, k) not in _PALLAS:
        _PALLAS[name, k] = np.asarray(jops.topk_threshold(jnp.asarray(x),
                                                          k=k))
    return _PALLAS[name, k]


def _ftz(x: np.ndarray) -> np.ndarray:
    """x with its denormals flushed to zero, as XLA's CPU backend reads it."""
    return np.where(np.abs(x) < TINY, np.float32(0), x)


def _ks(d: int) -> list:
    return sorted({1, 2, max(1, d // 10), max(1, d // 2), d - 1 or 1, d,
                   d + 1})


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("levels", [1, 2, 3, 5])
def test_topk_tree_walk_is_bitwise_sequential_and_pallas(levels, name):
    x = _case(name)
    d = x.shape[1]
    assert name != "ragged_slices" or d % CLUSTER
    assert (name == "denormals") != np.array_equal(_ftz(x), x,
                                                   equal_nan=True)
    absx = torch.from_numpy(x)
    for k in _ks(d):
        got = ref.topk_threshold_tree_ref(absx, k, levels)
        want = ref.topk_threshold_ref(absx, k)
        assert got.dtype == torch.float32 and got.shape == (x.shape[0], 1)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(
            ref.topk_threshold_tree_ref(torch.from_numpy(_ftz(x)), k,
                                        levels).numpy(), _pallas(name, x, k))
        if k > d:
            assert bool(torch.all(got == 0))
        elif name != "zero_and_nan_rows":
            assert bool(torch.all((absx >= got).sum(1) >= k))


def test_topk_tree_walk_edge_rows():
    """What the kernel's contract names: a NaN row gives 0, an all-zero
    row 0, k > D 0, and ties at the k-th value keep every tied entry."""
    x = _case("zero_and_nan_rows")
    got = ref.topk_threshold_tree_ref(torch.from_numpy(x), 5, LEVELS)
    assert float(got[1, 0]) == 0.0 and float(got[2, 0]) == 0.0
    assert float(got[0, 0]) > 0.0
    t = _case("ties")
    absx = torch.from_numpy(t)
    for k in (1, 40, 250, 499):
        got = ref.topk_threshold_tree_ref(absx, k, LEVELS)
        kth = torch.sort(absx, dim=1, descending=True).values[:, k - 1:k]
        # at most one ulp below the k-th value: every tie survives
        assert bool(torch.all(got <= kth))
        assert bool(torch.all(torch.nextafter(got, torch.full_like(got, 9))
                              >= kth))
        assert bool(torch.all((absx >= got).sum(1) >= (absx >= kth).sum(1)))


def test_topk_tree_walk_refuses_bad_args():
    absx = torch.ones((2, 5))
    with pytest.raises(ValueError, match="k must be"):
        ref.topk_threshold_tree_ref(absx, 0, 3)
    with pytest.raises(ValueError, match="levels"):
        ref.topk_threshold_tree_ref(absx, 1, 0)


def test_topk_subnormal_midpoints_match_pallas():
    """A normal row of ~1e-37 magnitudes (its smallest ones subnormal)
    between ordinary rows, k = 199 of D = 200: the bisection's midpoints
    fall below f32's normal range, where the reference's XLA run flushes
    them to 0, so the threshold is 0 and all 200 coordinates survive.
    The sequential version, its multi-level walk at every level count
    and the Pallas kernel (interpret mode) agree bitwise on the inputs as
    they are; the ordinary rows keep exactly k."""
    rng = np.random.default_rng(199)
    x = np.abs(rng.standard_normal((3, 200))).astype(np.float32)
    x[1] *= np.float32(1e-37)
    assert np.any(x[1] < TINY) and np.all(x[1] > 0)
    absx = torch.from_numpy(x)
    want = np.asarray(jops.topk_threshold(jnp.asarray(x), k=199))
    got = ref.topk_threshold_ref(absx, 199)
    np.testing.assert_array_equal(got.numpy(), want)
    for levels in (1, 2, 3, 5):
        np.testing.assert_array_equal(
            ref.topk_threshold_tree_ref(absx, 199, levels).numpy(), want)
    assert float(got[1, 0]) == 0.0
    assert ((absx >= got).sum(1) == torch.tensor([199, 200, 199])).all()
