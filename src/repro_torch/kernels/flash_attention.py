"""CUDA wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of `repro/kernels/flash_attention.py` (the Pallas kernel).
`flash_attention_cuda` takes q (B, H, Sq, hd) and k, v (B, Kh, Sk, hd) as
strided views (unit stride on hd), so the model hands over its
(B, S, H, hd) activations and slices of its (B, C, Kh, hd) caches
transposed, without a copy.  It checks what the kernel takes, allocates
the output with q's layout and launches on PyTorch's current stream.  The
TPU wrapper's padding of Sq and Sk to its blocks has no counterpart: the
kernel masks its own ragged edges.  Callers go through
`kernels.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535          # heads on the grid's y, batch rows on its z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = _build.load("flash_attention")
    if not _bound:
        lib.repro_flash_attention.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        lib.repro_flash_attention.restype = ctypes.c_int
        _bound = True
    return lib


def _check_layout(name: str, t: torch.Tensor) -> None:
    """Unit stride on hd; 16-byte aligned rows wherever a dim has >1 entry
    (the kernel loads 8 elements at a time)."""
    per16 = 16 // t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        raise ValueError(f"{name}: needs unit stride on head_dim and a "
                         f"16-byte aligned start, got strides {t.stride()}")
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        if size > 1 and stride % per16:
            raise ValueError(f"{name}: strides {t.stride()} are not "
                             f"multiples of {per16} elements")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Sq, hd), k and v (B, Kh, Sk, hd) on one CUDA device, one
    dtype (f32 or bf16), H % Kh == 0, hd % 8 == 0 and hd <= 256 -> out
    (B, H, Sq, hd) in q's dtype and layout."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                        "need one of float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, H, Sq, hd) and "
                         "(B, Kh, Sk, hd) twice")
    b, h, sq, hd = q.shape
    kb, kh, sk, khd = k.shape
    if kb != b or khd != hd or kh < 1 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head_dim, H % Kh)")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} not supported (a multiple of 8 up "
                         f"to {MAX_HEAD_DIM})")
    if min(b, h, sq, sk) < 1 or max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"empty or oversized shape B={b}, H={h}, Sq={sq}, "
                         f"Sk={sk}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not float(softcap) > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)
    lib = _lib()
    out = torch.empty_like(q)
    _check_layout("out", out)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                        *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, h, kh, sq, sk, hd, int(bool(causal)),
            0 if window is None else int(window), 1.0 / math.sqrt(hd),
            0.0 if softcap is None else float(softcap), _DTYPES[q.dtype],
            stream)
    _build.check(err, "flash_attention")
    return out
