"""CUDA wrappers of the QSGD kernels (``csrc/quantize.cu``).

Counterpart of `repro/kernels/quantize.py` (the Pallas kernels
`rowwise_absmax`, `qsgd_quantize`, `qsgd_dequantize`).  Two kernels:

* the row pass, a cluster of `CLUSTER` blocks a row that reads x once and
  writes what its caller asks for: `rowwise_absmax_cuda` (absmax),
  `qsgd_encode_cuda` (absmax and int32 levels) or `qsgd_roundtrip_cuda`
  (the dequantized values, the channel crossing's call);
* the stream, elementwise over the flat (m, D) buffer:
  `qsgd_quantize_cuda` (levels with absmax given, the Pallas kernel's own
  signature) and `qsgd_dequantize_cuda`.

Each wrapper checks what its kernel takes, allocates the outputs and makes
one launch on PyTorch's current stream; it raises on anything else.  The
level constant 1/s is rounded to f32 on the host, as
`kernels.ref.qsgd_levels` rounds it, and handed to the kernel as that f32
value.  Callers go through `kernels.ops`, which picks these for CUDA
tensors and the plain versions for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import qsgd_levels

CLUSTER = 8                  # blocks a row (csrc/quantize.cu kCluster)
THREADS = 256                # threads a block (kThreads)
REG_MAX = 32                 # values a thread in registers, at most
MAX_ROWS = (2 ** 31 - 1) // CLUSTER   # the row pass's clusters on grid x
MAX_D = 2 ** 31 - 1          # the row pass indexes a row with 32 bits
# what the row pass writes (kAbsmax, kEncode, kRoundtrip)
_ABSMAX, _ENCODE, _ROUNDTRIP = 0, 1, 2
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("quantize")
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f = ctypes.c_float
        lib.repro_qsgd_row_pass.argtypes = [p, p, p, p, p, i, ll, i, i, f, f,
                                            p]
        lib.repro_qsgd_quantize.argtypes = [p, p, p, p, i, ll, f, f, p]
        lib.repro_qsgd_dequantize.argtypes = [p, p, p, i, ll, f, p]
        for fn in (lib.repro_qsgd_row_pass, lib.repro_qsgd_quantize,
                   lib.repro_qsgd_dequantize):
            fn.restype = ctypes.c_int
        _bound = True
    return lib


def row_slots(d: int) -> int:
    """Register slots a thread of the row pass takes for a row of ``d``
    f32 (8, 16, 24 or 32, covering the block's eighth of the row), or 0
    when the row is too long for registers and is re-read from global
    memory after the exchange."""
    slice_ = -(-int(d) // CLUSTER)
    per = -(-slice_ // THREADS)
    if per > REG_MAX:
        return 0
    return 8 if per <= 8 else -(-per // 8) * 8


def row_path(d: int) -> str:
    """Where the row pass holds a row of ``d`` f32: ``"registers"`` (up to
    32 values a thread, D <= 65,536) or ``"global"`` (re-read, from L2,
    after the exchange of the row's max)."""
    return "registers" if row_slots(d) else "global"


def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")
    m, d = t.shape
    if not 1 <= m <= MAX_ROWS or not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: shape ({m}, {d}) outside 1 <= m <= "
                         f"{MAX_ROWS}, 1 <= D <= {MAX_D}")


def _check_noise(noise: torch.Tensor, x: torch.Tensor) -> None:
    _check_rows("noise", noise, torch.float32)
    if noise.shape != x.shape or noise.device != x.device:
        raise ValueError(f"noise {tuple(noise.shape)} on {noise.device} does "
                         f"not match x {tuple(x.shape)} on {x.device}")


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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _row_pass(x: torch.Tensor, noise: Optional[torch.Tensor], out: int,
              bits: Optional[int]) -> Tuple[Optional[torch.Tensor], ...]:
    """One launch of the row pass: (absmax, levels, values), each None
    where ``out`` does not write it; absmax alone takes no ``bits``."""
    s, inv_s = (0.0, 0.0) if bits is None else qsgd_levels(bits)
    _check_rows("x", x, torch.float32)
    if out != _ABSMAX:
        _check_noise(noise, x)
    m, d = x.shape
    lib = _lib()
    amax = x.new_empty((m, 1)) if out != _ROUNDTRIP else None
    q = x.new_empty((m, d), dtype=torch.int32) if out == _ENCODE else None
    values = x.new_empty((m, d)) if out == _ROUNDTRIP else None
    with torch.cuda.device(x.device):
        err = lib.repro_qsgd_row_pass(x.data_ptr(), _ptr(noise), _ptr(amax),
                                      _ptr(q), _ptr(values), m, d,
                                      row_slots(d), out, s, float(inv_s),
                                      _stream(x))
    _build.check(err, "qsgd_row_pass")
    return amax, q, values


def rowwise_absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """(m, D) contiguous f32 CUDA -> (m, 1) f32 per-row max |x| (NaN rows
    give NaN); the row pass, absmax alone."""
    return _row_pass(x, None, _ABSMAX, None)[0]


def qsgd_encode_cuda(x: torch.Tensor, noise: torch.Tensor,
                     bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(levels int32 (m, D), absmax (m, 1))`` of x, u (m, D) f32 in one
    launch: the row pass, absmax then levels from the same read of x."""
    amax, q, _ = _row_pass(x, noise, _ENCODE, bits)
    return q, amax


def qsgd_roundtrip_cuda(x: torch.Tensor, noise: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """dequantize(quantize(x)) of x, u (m, D) f32 in one launch: the row
    pass writes ``float(q) · scale`` and neither levels nor absmax."""
    return _row_pass(x, noise, _ROUNDTRIP, bits)[2]


def qsgd_quantize_cuda(x: torch.Tensor, noise: torch.Tensor,
                       absmax: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 levels ``clip(floor(x·inv + u), −s, s)`` of x, u (m, D) f32
    given absmax (m, 1) f32; bits in [2, 8].  The stream."""
    s, inv_s = qsgd_levels(bits)
    _check_rows("x", x, torch.float32)
    _check_noise(noise, x)
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
    """float(q) · (absmax·(1/s)): (m, D) int32, (m, 1) f32 -> (m, D) f32.
    The stream."""
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
