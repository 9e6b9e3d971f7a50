"""CUDA wrapper of the top-k threshold kernel (``csrc/topk_threshold.cu``).

Counterpart of `repro/kernels/topk_threshold.py`.  `topk_threshold_cuda`
takes k as a runtime int (the TPU kernel bakes it into its body), checks
what the kernel takes, allocates the (m, 1) output and launches one
cluster of `CLUSTER` blocks per row on PyTorch's current stream.  Callers
go through `kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

CLUSTER = 8                  # blocks a row (csrc/topk_threshold.cu kCluster)
LEVELS = 3                   # bisection steps a pass (kLevels)
MAX_ROWS = (2 ** 31 - 1) // CLUSTER   # the clusters on the grid's x
MAX_D = 2 ** 31 - 1          # counts are 32-bit
PATHS = ("registers", "shared", "global")
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("topk_threshold")
    if not _bound:
        lib.repro_topk_threshold.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.repro_topk_threshold.restype = ctypes.c_int
        lib.repro_topk_threshold_path.argtypes = [ctypes.c_longlong]
        lib.repro_topk_threshold_path.restype = ctypes.c_int
        _bound = True
    return lib


def row_path(d: int) -> str:
    """Where the kernel holds a row of ``d`` f32 on the current card:
    ``"registers"`` (up to 32 values a thread, D <= 65,536), ``"shared"``
    (a block's eighth of the row in shared memory) or ``"global"`` (the
    row re-read from global memory on every pass)."""
    return PATHS[_lib().repro_topk_threshold_path(int(d))]


def topk_threshold_cuda(absx: torch.Tensor, k: int) -> torch.Tensor:
    """(m, D) contiguous f32 CUDA magnitudes -> (m, 1) f32 thresholds t
    with count(absx >= t) >= k; k >= 1 (k > D gives 0)."""
    if int(k) < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not absx.is_cuda:
        raise ValueError(f"topk_threshold_cuda needs a CUDA tensor, got "
                         f"{absx.device}")
    if (absx.dtype != torch.float32 or absx.dim() != 2
            or not absx.is_contiguous()):
        raise ValueError(f"absx must be a contiguous 2-D float32 tensor, got "
                         f"{absx.dtype} {tuple(absx.shape)}"
                         f"{'' if absx.is_contiguous() else ' (strided)'}")
    m, d = absx.shape
    if not 1 <= m <= MAX_ROWS or not 1 <= d <= MAX_D:
        raise ValueError(f"empty or oversized shape m={m}, D={d}")
    lib = _lib()
    out = torch.empty((m, 1), dtype=torch.float32, device=absx.device)
    stream = torch.cuda.current_stream(absx.device).cuda_stream
    with torch.cuda.device(absx.device):
        err = lib.repro_topk_threshold(absx.data_ptr(), out.data_ptr(), m, d,
                                       int(k), stream)
    _build.check(err, "topk_threshold")
    return out
