"""CUDA wrappers of the QSGD kernels (``csrc/quantize.cu``).

Counterpart of `repro/kernels/quantize.py` (the Pallas kernels
`rowwise_absmax`, `qsgd_quantize`, `qsgd_dequantize`).  Each wrapper
checks what its kernel takes, allocates the output and launches on
PyTorch's current stream; it raises on anything else.  The level
constant 1/s is rounded to f32 on the host, as `kernels.ref.qsgd_levels`
rounds it, and handed to the kernel as that f32 value.  Callers go
through `kernels.ops`, which picks these for CUDA tensors and the plain
versions for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import qsgd_levels

MAX_ROWS = 65535             # gridDim.y limit: rows ride on the grid's y
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("quantize")
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = ctypes.c_float
        lib.repro_rowwise_absmax.argtypes = [p, p, i, ll, p]
        lib.repro_qsgd_quantize.argtypes = [p, p, p, p, i, ll, f, f, p]
        lib.repro_qsgd_dequantize.argtypes = [p, p, p, i, ll, f, p]
        for fn in (lib.repro_rowwise_absmax, lib.repro_qsgd_quantize,
                   lib.repro_qsgd_dequantize):
            fn.restype = ctypes.c_int
        _bound = True
    return lib


def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")
    m, d = t.shape
    if not 1 <= m <= MAX_ROWS or d < 1:
        raise ValueError(f"{name}: shape ({m}, {d}) outside 1 <= m <= "
                         f"{MAX_ROWS}, D >= 1")


def _check_absmax(absmax: torch.Tensor, like: torch.Tensor) -> None:
    if (absmax.device != like.device or absmax.dtype != torch.float32
            or tuple(absmax.shape) != (like.shape[0], 1)
            or not absmax.is_contiguous()):
        raise ValueError(f"absmax must be a contiguous ({like.shape[0]}, 1) "
                         f"float32 tensor on {like.device}, got "
                         f"{absmax.dtype} {tuple(absmax.shape)} on "
                         f"{absmax.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rowwise_absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """(m, D) contiguous f32 CUDA -> (m, 1) f32 per-row max |x| (NaN rows
    give NaN)."""
    _check_rows("x", x, torch.float32)
    m, d = x.shape
    lib = _lib()
    out = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_rowwise_absmax(x.data_ptr(), out.data_ptr(), m, d,
                                       _stream(x))
    _build.check(err, "rowwise_absmax")
    return out


def qsgd_quantize_cuda(x: torch.Tensor, noise: torch.Tensor,
                       absmax: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 levels ``clip(floor(x·inv + u), −s, s)`` of x, u (m, D) f32
    given absmax (m, 1) f32; bits in [2, 8]."""
    s, inv_s = qsgd_levels(bits)
    _check_rows("x", x, torch.float32)
    _check_rows("noise", noise, torch.float32)
    if noise.shape != x.shape or noise.device != x.device:
        raise ValueError(f"noise {tuple(noise.shape)} on {noise.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")
    _check_absmax(absmax, x)
    m, d = x.shape
    lib = _lib()
    q = torch.empty((m, d), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.repro_qsgd_quantize(x.data_ptr(), noise.data_ptr(),
                                      absmax.data_ptr(), q.data_ptr(), m, d,
                                      s, float(inv_s), _stream(x))
    _build.check(err, "qsgd_quantize")
    return q


def qsgd_dequantize_cuda(q: torch.Tensor, absmax: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """float(q) · (absmax·(1/s)): (m, D) int32, (m, 1) f32 -> (m, D) f32."""
    _, inv_s = qsgd_levels(bits)
    _check_rows("q", q, torch.int32)
    _check_absmax(absmax, q)
    m, d = q.shape
    lib = _lib()
    out = torch.empty((m, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.repro_qsgd_dequantize(q.data_ptr(), absmax.data_ptr(),
                                        out.data_ptr(), m, d, float(inv_s),
                                        _stream(q))
    _build.check(err, "qsgd_dequantize")
    return out
