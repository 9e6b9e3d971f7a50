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
from repro_torch.kernels import quantize as Q
from repro_torch.kernels.mixing_aggregate import (N_MAX, SMEM_LIMIT, TILE,
                                                  copy_width, launch_groups,
                                                  smem_bytes)
from repro_torch.kernels.pairwise_sqdist import CLUSTER, gram_plan

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


def _micro_tiles(nb, diag):
    """(bi, bj) of each micro-tile, in the order csrc/gram.cu numbers them."""
    if diag:
        return [(bi, bj) for bi in range(nb) for bj in range(bi, nb)]
    return [(bi, bj) for bi in range(nb) for bj in range(nb)]


@pytest.mark.parametrize("m,d", [(1, 1), (20, 47571), (100, 47571),
                                 (3, 10 ** 8), (17, 31), (128, 5),
                                 (129, 1000), (300, 64)])
def test_gram_chunking_covers_d(m, d):
    """The one-launch Gram's grid: whole clusters whose blocks' column
    ranges cover D once, a block big enough for every tile's micro-tiles
    and lanes, within shared memory, and tiles whose upper micro-tiles
    cover every pair i <= j of the m rows exactly once."""
    p = gram_plan(m, d)
    assert p.chunk % 4 == 0 and p.blocks % CLUSTER == 0
    nblk = -(-d // p.chunk)
    assert (nblk - 1) * p.chunk < d <= nblk * p.chunk <= p.blocks * p.chunk
    assert p.blocks - nblk < CLUSTER and p.blocks * p.ny <= 65535 * 8
    assert p.te % 4 == 0 and p.te * p.nt >= m and p.te * (p.nt - 1) < m
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert p.smem <= 232448 and p.lanes in (1, 2, 4, 8, 16)
    nb, r_ = p.te // 4, 4
    seen = {}
    for ti in range(p.nt):
        for tj in range(ti, p.nt):
            tiles = _micro_tiles(nb, ti == tj)
            assert len(tiles) * p.lanes <= p.threads
            assert len(tiles) * r_ * r_ <= p.emax and p.emax % 16 == 0
            for bi, bj in tiles:
                for r in range(r_):
                    for c in range(r_):
                        i, j = ti * p.te + r_ * bi + r, tj * p.te + r_ * bj + c
                        if i < m and j < m and (ti != tj or i <= j):
                            seen[(i, j)] = seen.get((i, j), 0) + 1
    assert len(seen) == m * (m + 1) // 2 and set(seen.values()) == {1}
    # one wave: no more clusters than the card runs at once (30 at m = 100)
    q = gram_plan(m, d, max_clusters=30)
    assert q.blocks // CLUSTER <= max(1, 30 // q.ny) and q.blocks % CLUSTER == 0
    assert -(-d // q.chunk) <= q.blocks and q[:5] == p[:5]


@pytest.mark.parametrize("widths", [
    [150, 6, 2400, 16, 30720, 120, 10080, 84, 3948, 47],    # LeNet-5
    [1, 6, 127, 128, 129, 4099],
    [1 + (7 * i) % 300 for i in range(N_MAX + 9)],         # two launches
])
def test_mix_launch_groups_cover_every_column(widths):
    """Every column of every leaf falls in exactly one block's tile, and no
    launch takes more than N_MAX leaves."""
    groups = launch_groups(widths)
    assert len(groups) == -(-len(widths) // N_MAX)
    assert [i for idx, _ in groups for i in idx] == list(range(len(widths)))
    covered = {i: np.zeros(d, int) for i, d in enumerate(widths)}
    for idx, prefix in groups:
        assert 1 <= len(idx) <= N_MAX and len(prefix) == len(idx) + 1
        for t in range(prefix[-1]):           # block x = t, as the kernel
            leaf = max(a for a in range(len(idx)) if prefix[a] <= t)
            d = widths[idx[leaf]]
            col0 = (t - prefix[leaf]) * TILE
            ncols = min(TILE, d - col0)
            assert ncols >= 1
            covered[idx[leaf]][col0:col0 + ncols] += 1
    assert all((c == 1).all() for c in covered.values())


@pytest.mark.parametrize("ptr,d,elt,want", [
    (0, 150, 4, 8), (0, 6, 4, 8), (0, 47, 4, 4), (0, 2400, 4, 16),
    (4, 2400, 4, 4), (8, 2400, 4, 8), (0, 127, 2, 2), (2, 128, 2, 2),
    (0, 6, 2, 4), (8, 4, 2, 8), (0, 8, 2, 16), (256, 129, 4, 4)])
def test_mix_copy_width(ptr, d, elt, want):
    """The widest cp.async a leaf's base and row stride allow: LeNet's
    conv1 (150 columns, 600-byte rows) takes 8 bytes, a bf16 leaf of odd
    width plain loads (2)."""
    assert copy_width(ptr, d, elt) == want


def test_mix_smem_bytes():
    assert smem_bytes(20, 20, 4) == 20 * 36 * 4 + 20 * TILE * 4
    assert smem_bytes(100, 100, 4) == 100 * 116 * 4 + 32 * TILE * 4
    assert 3 * smem_bytes(100, 100, 4) <= 232448    # three blocks an SM
    assert smem_bytes(1, 400, 2) < SMEM_LIMIT < smem_bytes(128, 450, 4)


@pytest.mark.parametrize("d,slots", [
    (1, 8), (9, 8), (4099, 8), (16384, 8), (16385, 16), (47571, 24),
    (49153, 32), (65536, 32), (65537, 0), (70000, 0), (600000, 0)])
def test_qsgd_row_slots_hold_the_slice(d, slots):
    """The QSGD row pass's register slots a thread: the fewest multiple of
    8 whose 256 threads hold a block's eighth of the row, up to 32 (D =
    65,536); a longer row takes the re-read path (0, "global")."""
    assert Q.row_slots(d) == slots
    assert Q.row_path(d) == ("registers" if slots else "global")
    slice_ = -(-d // Q.CLUSTER)
    if slots:
        assert slots * Q.THREADS >= slice_
        assert slots == 8 or (slots - 8) * Q.THREADS < slice_
    else:
        assert Q.REG_MAX * Q.THREADS < slice_


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixing_aggregate_leaves_cpu_equals_one_leaf_calls(dtype):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(_rows(5, 7, rng))
    thetas = [torch.from_numpy(rng.standard_normal((7, d)).astype(
        np.float32)).to(dtype) for d in (1, 6, 127, 129)]
    got = ops.mixing_aggregate_leaves(w, thetas)
    for g, t in zip(got, thetas):
        want = ops.mixing_aggregate(w, t)
        assert g.dtype == dtype and torch.equal(g, want)
