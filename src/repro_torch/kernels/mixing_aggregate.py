"""CUDA wrapper of the Y = W Θ kernel (``csrc/mixing_aggregate.cu``).

Counterpart of `repro/kernels/mixing_aggregate.py` (the Pallas kernel).
`mixing_aggregate_cuda` checks what the kernel takes, allocates the
output and launches on PyTorch's current stream; it raises on anything
else.  Callers go through `kernels.ops.mixing_aggregate`, which picks this
for CUDA tensors and the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("mixing_aggregate")
    if not _bound:
        lib.repro_mixing_aggregate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.repro_mixing_aggregate.restype = ctypes.c_int
        lib.repro_mixing_aggregate_smem.argtypes = [ctypes.c_int,
                                                    ctypes.c_int]
        lib.repro_mixing_aggregate_smem.restype = ctypes.c_longlong
        _bound = True
    return lib


def mixing_aggregate_cuda(w: torch.Tensor, theta: torch.Tensor
                          ) -> torch.Tensor:
    """Y = W Θ on the card: w (k, m) any float dtype (used as fp32),
    theta (m, D) contiguous fp32/bf16 CUDA -> (k, D) in theta's dtype."""
    if not theta.is_cuda or w.device != theta.device:
        raise ValueError(f"mixing_aggregate_cuda needs w and theta on one "
                         f"CUDA device, got {w.device} and {theta.device}")
    if theta.dtype not in _DTYPES:
        raise TypeError(f"theta dtype {theta.dtype} not supported "
                        "(float32 or bfloat16)")
    if w.dim() != 2 or theta.dim() != 2 or w.shape[1] != theta.shape[0]:
        raise ValueError(f"shapes w {tuple(w.shape)} x theta "
                         f"{tuple(theta.shape)} do not contract")
    if not theta.is_contiguous():
        raise ValueError("theta must be contiguous")
    k, m = w.shape
    d = theta.shape[1]
    if k < 1 or m < 1 or d < 1:
        raise ValueError(f"empty shape k={k}, m={m}, D={d}")
    lib = _lib()
    smem = lib.repro_mixing_aggregate_smem(k, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"W ({k}x{m}) needs {smem} B of shared memory, "
                         f"above the {SMEM_LIMIT} B a block can use")
    wf = w.to(torch.float32).contiguous()
    out = torch.empty((k, d), dtype=theta.dtype, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    with torch.cuda.device(theta.device):
        err = lib.repro_mixing_aggregate(
            wf.data_ptr(), theta.data_ptr(), out.data_ptr(), k, m, d,
            _DTYPES[theta.dtype], stream)
    _build.check(err, "mixing_aggregate")
    return out
