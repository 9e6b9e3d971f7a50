"""CUDA wrappers of the flash-attention kernels and the rule between them.

Counterpart of `repro/kernels/flash_attention.py` (the Pallas kernel), by
three kernels: ``csrc/flash_decode.cu`` (Sq <= 16: split keys, then
merge; `flash_decode_cuda`), ``csrc/flash_attention_tc.cu`` (bf16 prefill
on the tensor cores at the head dims of `TC_PAIRS`,
`flash_attention_tc_cuda`) and ``csrc/flash_attention.cu`` (f32 CUDA
cores, any head dims up to 256, `flash_attention_cuda`).  `flash_route`
states which one a call takes.
Each takes q (B, H, Sq, dk), k (B, Kh, Sk, dk) and v (B, Kh, Sk, dv) as
strided views (unit stride on the head dim), so the model hands over its
(B, S, H, ·) activations and slices of its (B, C, Kh, ·) caches
transposed, without a copy.  The value head dim dv may differ from the
query/key head dim dk (MLA: dk 192, dv 128); the logits are scaled by
1/√dk and the output is (B, H, Sq, dv).  Each checks what its kernel
takes, allocates the output with q's layout (and the decode kernel's
workspace) and launches on PyTorch's current stream.  The TPU wrapper's
padding of Sq and Sk to its blocks has no counterpart: the kernels mask
their own ragged edges.  Callers go through `kernels.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535          # heads on the grid's y, batch rows on its z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (dk, dv) of the tensor-core kernel's instances
TC_PAIRS = ((64, 64), (80, 80), (128, 128), (192, 192), (256, 256),
            (192, 128))
DECODE_MAX_SQ = 16           # queries of the decode kernel (decode steps)
DECODE_MIN_KEYS = 128        # keys a decode split keeps at least
DECODE_BLOCKS_PER_SM = 3     # decode blocks a split count aims for
# the C entries: q, k, v, out, strides, B, H, Kh, Sq, Sk, dk, dv, causal,
# window, scale, softcap, dtype, stream; the decode kernel's adds its
# workspace and n_split
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
    [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
_EXTRA_ARGTYPES = {"flash_decode": [ctypes.c_void_p, ctypes.c_int]}
_bound = set()
_n_sm: Dict[int, int] = {}


def flash_route(dtype: torch.dtype, sq: int, hd: int,
                dv: Optional[int] = None) -> str:
    """Which kernel a CUDA call takes, at query/key head dim ``hd`` and
    value head dim ``dv`` (default ``hd``): ``"decode"`` (the split-key
    decode kernel) iff Sq <= 16, in either dtype and at any head dims;
    else ``"tc"`` (the tensor-core kernel) iff the inputs are bf16 and
    (hd, dv) is (64, 64), (80, 80), (128, 128), (192, 192), (256, 256) or
    (192, 128) (every bf16 prefill of the served configs: nemotron's hd
    192 and MLA's (192, 128) included); else
    ``"cuda_core"`` (f32 prefill, bf16 prefill at any other head dims).
    From Sq 17 up the tensor-core kernel is the faster of the two prefill
    kernels (both are timed at Sq 17, 32, 64 and 128 over the serving
    cache by ``chip_smoke.py``; PERF.md has the times)."""
    if sq <= DECODE_MAX_SQ:
        return "decode"
    if dtype == torch.bfloat16 and (hd, hd if dv is None else dv) in \
            TC_PAIRS:
        return "tc"
    return "cuda_core"


def decode_splits(b: int, kh: int, sk: int, n_sm: int) -> int:
    """Key splits of the decode kernel: as many as keep the (batch row, KV
    head) pairs' blocks within three a SM (one wave), each split keeping
    at least 128 keys; ``clamp(floor(3·n_sm / (B·Kh)), 1, ceil(Sk /
    128))``.  Three blocks a SM and the floor were tuned on the card
    (PERF.md): a second wave of blocks costs more than it spreads."""
    want = DECODE_BLOCKS_PER_SM * n_sm // (b * kh)
    return max(1, min(want, -(-sk // DECODE_MIN_KEYS)))


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def _entry(name: str):
    """The C entry ``repro_<name>`` of ``csrc/<name>.cu``, built and
    bound on first use."""
    fn = getattr(_build.load(name), f"repro_{name}")
    if name not in _bound:
        fn.argtypes = _ARGTYPES + _EXTRA_ARGTYPES.get(name, [])
        fn.restype = ctypes.c_int
        _bound.add(name)
    return fn


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


def _out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty (B, H, Sq, dv) tensor whose (b, h, s) dims are laid out
    in q's order (the model's (B, S, H, ·) activations transposed)."""
    if dv == q.shape[-1]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda d: (-q.stride(d), d))
    out = q.new_empty([q.shape[d] for d in order] + [dv])
    return out.permute(*(order.index(d) for d in range(3)), 3)


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int], softcap: Optional[float],
            dtypes: tuple, pairs: Optional[tuple],
            max_sq: Optional[int] = None,
            n_split: Optional[int] = None) -> torch.Tensor:
    """Check what kernel ``name`` takes (``dtypes``; ``pairs`` of (dk,
    dv), or None for any multiples of 8 up to 256; ``max_sq``, or None
    for any Sq), then launch it.  ``n_split`` is the decode kernel's: its
    workspace is allocated here."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: dtypes q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}: need one of {dtypes}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, H, Sq, dk), "
                         "(B, Kh, Sk, dk) and (B, Kh, Sk, dv)")
    b, h, sq, hd = q.shape
    kb, kh, sk, khd = k.shape
    dv = v.shape[3]
    if kb != b or khd != hd or kh < 1 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head_dim, H % Kh)")
    for d in (hd, dv):
        if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"{name}: head dims dk {hd}, dv {dv} not "
                             f"supported (multiples of 8 up to "
                             f"{MAX_HEAD_DIM})")
    if pairs is not None and (hd, dv) not in pairs:
        raise ValueError(f"{name}: head dims dk {hd}, dv {dv} not "
                         f"supported (one of {pairs})")
    if min(b, h, sq, sk) < 1 or max(b, h) > MAX_GRID_YZ:
        raise ValueError(f"empty or oversized shape B={b}, H={h}, Sq={sq}, "
                         f"Sk={sk}")
    if max_sq is not None and sq > max_sq:
        raise ValueError(f"{name}: takes at most {max_sq} queries, got "
                         f"Sq={sq}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not float(softcap) > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(arg, t)
    extra = ()
    if name == "flash_decode":
        if n_split is None:
            n_split = decode_splits(b, kh, sk, sm_count(q.device))
        if int(n_split) < 1:
            raise ValueError(f"n_split must be >= 1, got {n_split}")
        ws = torch.empty((b, h, sq, int(n_split), dv + 2),
                         dtype=torch.float32, device=q.device)
        extra = (ws.data_ptr(), int(n_split))
    fn = _entry(name)
    out = _out_like(q, dv)
    _check_layout("out", out)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                        *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 strides, b, h, kh, sq, sk, hd, dv, int(bool(causal)),
                 0 if window is None else int(window), 1.0 / math.sqrt(hd),
                 0.0 if softcap is None else float(softcap),
                 _DTYPES[q.dtype], stream, *extra)
    _build.check(err, name)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """The CUDA-core kernel: q (B, H, Sq, dk), k (B, Kh, Sk, dk) and v
    (B, Kh, Sk, dv) on one CUDA device, one dtype (f32 or bf16),
    H % Kh == 0, dk and dv multiples of 8 up to 256 -> out (B, H, Sq, dv)
    in q's dtype and layout."""
    return _launch("flash_attention", q, k, v, causal, window, softcap,
                   tuple(_DTYPES), None)


def flash_attention_tc_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """The tensor-core kernel: as `flash_attention_cuda`, for bf16 and
    the (dk, dv) pairs of `TC_PAIRS` only (raises on anything else)."""
    return _launch("flash_attention_tc", q, k, v, causal, window, softcap,
                   (torch.bfloat16,), TC_PAIRS)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      n_split: Optional[int] = None) -> torch.Tensor:
    """The split-key decode kernel: as `flash_attention_cuda`, for
    Sq <= 16 only (raises on more).  The keys are cut into ``n_split``
    contiguous ranges (default `decode_splits` on this card's SM count)
    whose partials are merged in split order, so the result is bitwise
    the same from call to call."""
    return _launch("flash_decode", q, k, v, causal, window, softcap,
                   tuple(_DTYPES), None, max_sq=DECODE_MAX_SQ,
                   n_split=n_split)
