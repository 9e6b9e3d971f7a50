"""CUDA wrapper of the Gram + Δ kernel (``csrc/gram.cu``).

Counterpart of `repro/kernels/pairwise_sqdist.py`.  `gram_sqdist_cuda`
launches the one-launch deterministic kernel that writes G = g gᵀ and
Δ = max((G_ii + G_jj) − 2·G_ij, 0), bitwise `kernels.ref.sqdist_from_gram`
of that G.  `gram_plan` sizes its grid.  Callers go through `kernels.ops`
(`gram_matrix` returns G, `pairwise_sqdist` Δ).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

CLUSTER = 8                  # blocks of a thread-block cluster (kCluster)
TD, QUADS, STAGES = 64, 16, 3  # slice columns, float4 quads, ring depth
TARGET_BLOCKS = 2 * 132      # two blocks for each of the H100's 132 SMs,
                             # capped at one wave of clusters
SMEM_LIMIT = 232448
_bound = False
# per (device index, stream handle): the kernel's ticket counters, zeroed
# once and left at zero by every launch (see csrc/gram.cu on why two
# streams must not share them)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}
_MAX_CLUSTERS: Dict[Tuple[int, int, int], int] = {}   # per block shape


class GramPlan(NamedTuple):
    te: int          # rows of an output tile's side (a multiple of 4)
    nt: int          # tiles a side; ny = nt (nt + 1) / 2 tiles run
    lanes: int       # threads that split one micro-tile's slice quads
    threads: int     # threads a block
    emax: int        # floats of a block's partial (4x4 micro-tiles x 16)
    chunk: int       # D columns a block owns (a multiple of 4)
    blocks: int      # blocks a tile (a multiple of CLUSTER)

    @property
    def ny(self) -> int:
        return self.nt * (self.nt + 1) // 2

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a block (``repro_gram_smem``)."""
        stage = QUADS * 4 * self.te * (2 if self.nt > 1 else 1)
        return 4 * (max(STAGES * stage, self.threads * 16) + self.emax)


def gram_plan(m: int, d: int, max_clusters: Optional[int] = None
              ) -> GramPlan:
    """The grid of one (m, D) Gram: one diagonal tile of te = m rounded up
    to 4 for m <= 128, else 64-row tiles; ~TARGET_BLOCKS blocks in all,
    each owning ``chunk`` columns of D, in whole clusters of CLUSTER, and
    no more clusters than ``max_clusters`` (what the card runs at once:
    one wave)."""
    if m <= 128:
        te, nt = -(-m // 4) * 4, 1
        nb = te // 4
        tmax = nb * (nb + 1) // 2
    else:
        te, nt = 64, -(-m // 64)
        tmax = (te // 4) ** 2
    lanes = 1
    while lanes < 16 and 2 * lanes * tmax <= 256:
        lanes *= 2
    threads = -(-tmax * lanes // 32) * 32
    ny = nt * (nt + 1) // 2
    want = max(CLUSTER, TARGET_BLOCKS // ny)
    if max_clusters is not None:
        want = min(want, CLUSTER * max(1, max_clusters // ny))
    per = -(-d // want)
    chunk = -(-per // 4) * 4
    nblk = -(-d // chunk)
    blocks = -(-nblk // CLUSTER) * CLUSTER
    return GramPlan(te, nt, lanes, threads, tmax * 16, chunk, blocks)


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("gram")
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_gram_sqdist.argtypes = [p, p, p, p, p, i, ll, i, i, ll, i,
                                          i, i, i, p]
        lib.repro_gram_max_clusters.argtypes = [i, ll]
        lib.repro_gram_max_clusters.restype = i
        lib.repro_gram_sqdist.restype = ctypes.c_int
        _bound = True
    return lib


def card_plan(m: int, d: int, device: torch.device) -> Tuple[GramPlan, int]:
    """The plan a launch on ``device`` takes, and the clusters of its blocks
    the card runs at once (cudaOccupancyMaxActiveClusters, asked once per
    block shape): the grid is at most that one wave."""
    plan = gram_plan(m, d)
    if plan.smem > SMEM_LIMIT:
        raise ValueError(f"m={m} needs {plan.smem} B of shared memory, above "
                         f"the {SMEM_LIMIT} B a block can use")
    key = (device.index, plan.threads, plan.smem)
    n = _MAX_CLUSTERS.get(key)
    if n is None:
        with torch.cuda.device(device):
            n = _lib().repro_gram_max_clusters(plan.threads, plan.smem)
        if n < 1:
            raise RuntimeError(f"gram_matrix: no cluster of {CLUSTER} blocks "
                               f"of {plan.threads} threads and {plan.smem} B "
                               f"fits (cudaOccupancyMaxActiveClusters: {n})")
        _MAX_CLUSTERS[key] = n
    return gram_plan(m, d, n), n


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return c


def gram_sqdist_cuda(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, Δ) on the card from one launch: g (m, D) contiguous fp32 CUDA ->
    two (m, m) fp32 views of one buffer."""
    if not g.is_cuda:
        raise ValueError(f"gram_sqdist_cuda needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous 2-D float32 tensor, got "
                         f"{g.dtype} {tuple(g.shape)}")
    m, d = g.shape
    if m < 1 or d < 1:
        raise ValueError(f"empty shape m={m}, D={d}")
    plan, _ = card_plan(m, d, g.device)
    lib = _lib()
    out = torch.empty(2 * m * m, dtype=torch.float32, device=g.device)
    gram, delta = out[:m * m].view(m, m), out[m * m:].view(m, m)
    scratch = torch.empty(plan.ny * (plan.blocks // CLUSTER) * plan.emax,
                          dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    counters = _counters(g.device, stream, plan.ny + 1)
    with torch.cuda.device(g.device):
        err = lib.repro_gram_sqdist(
            g.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
            gram.data_ptr(), delta.data_ptr(), m, d, plan.te, plan.nt,
            plan.chunk, plan.blocks, plan.lanes, plan.threads, plan.emax,
            stream)
    _build.check(err, "gram_matrix")
    return gram, delta
