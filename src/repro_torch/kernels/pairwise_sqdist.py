"""CUDA wrapper of the Gram kernel (``csrc/gram.cu``).

Counterpart of `repro/kernels/pairwise_sqdist.py`.  `gram_matrix_cuda`
launches the deterministic two-pass Gram kernel; Δ is then assembled
from the Gram diagonal outside the kernel, as the reference does
(`kernels.ref.sqdist_from_gram`).  Callers go through `kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TILE, TD = 16, 32            # must match kTile / kTd in csrc/gram.cu
TARGET_BLOCKS = 4 * 132      # a few waves of blocks over the H100's 132 SMs
MAX_CHUNKS = 65535           # gridDim.z limit
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("gram")
    if not _bound:
        lib.repro_gram_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.repro_gram_matrix.restype = ctypes.c_int
        _bound = True
    return lib


def chunking(m: int, d: int):
    """(chunk, nchunks): D split into chunks (multiples of 32 columns) so
    that tiles x chunks gives about TARGET_BLOCKS blocks in pass 1."""
    tiles = (-(-m // TILE)) ** 2
    want = max(1, -(-TARGET_BLOCKS // tiles))
    chunk = -(-d // want)
    chunk = -(-chunk // TD) * TD
    nchunks = -(-d // chunk)
    while nchunks > MAX_CHUNKS:
        chunk *= 2
        nchunks = -(-d // chunk)
    return chunk, nchunks


def gram_matrix_cuda(g: torch.Tensor) -> torch.Tensor:
    """G = g gᵀ on the card: g (m, D) contiguous fp32 CUDA -> (m, m) fp32."""
    if not g.is_cuda:
        raise ValueError(f"gram_matrix_cuda needs a CUDA tensor, got "
                         f"{g.device}")
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous 2-D float32 tensor, got "
                         f"{g.dtype} {tuple(g.shape)}")
    m, d = g.shape
    if m < 1 or d < 1:
        raise ValueError(f"empty shape m={m}, D={d}")
    lib = _lib()
    chunk, nchunks = chunking(m, d)
    partial = torch.empty((nchunks, m, m), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((m, m), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = lib.repro_gram_matrix(g.data_ptr(), partial.data_ptr(),
                                    out.data_ptr(), m, d, chunk, nchunks,
                                    stream)
    _build.check(err, "gram_matrix")
    return out
