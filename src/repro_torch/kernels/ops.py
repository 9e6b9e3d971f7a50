"""Public kernel ops, dispatched by the tensor's device.

Counterpart of `repro/kernels/ops.py`.  A CUDA tensor goes to the
hand-written kernel (a missing ``nvcc``, a build error or a launch error
raises — there is no fallback); a CPU tensor goes to the plain version in
`kernels.ref`.  The TPU wrapper's row padding to 8 sublanes / 128 lanes
has no counterpart: the CUDA kernels mask their own edges.

``LAUNCHES`` counts kernel launches per op (CUDA only), so a run can show
that its path went through the kernels:

    ops.LAUNCHES["mixing_aggregate"] = 0
    run_federated("ucfl", fed)
    assert ops.LAUNCHES["mixing_aggregate"] == rounds   # a tree, one launch

The mix takes a whole parameter tree in one launch (up to
``mixing_aggregate.N_MAX`` leaves a launch); the Gram op computes G and
Δ in one launch, counted under ``gram_matrix``.

The channel codecs add ``qsgd_roundtrip`` (one per qsgd uplink: absmax,
levels and values in one launch of the QSGD row pass) and
``topk_threshold`` (one per top-k uplink); ``rowwise_absmax``,
``qsgd_quantize`` (the row pass's encode) and ``qsgd_dequantize`` (the
QSGD stream) count their own calls, one launch each.  The LM path adds
one launch per attention layer per prefill or decode step, counted
under the kernel `flash_route` picks (``FLASH_COUNTERS``):
``flash_attention_decode`` (the split-key decode kernel, Sq <= 16; one
count a call, though it makes two launches, the partials and the
merge), ``flash_attention_tc`` (the tensor-core kernel, bf16 prefill) or
``flash_attention`` (the CUDA-core kernel, the other prefills).

Flash attention is a registered operator, ``repro_torch::flash_attention``
(`torch.library`: a CPU implementation, the plain version, a CUDA one,
`flash_route`'s kernel, and a Meta one, its output's shape for the
planner, whose `torch.utils.flop_counter` formula counts the kept
(query, key) pairs), so that it runs under `torch.func.vmap`: its
batching rule folds the vmapped dimension into the kernel's batch
dimension and launches once for every user of a served batch (one count),
each user's rows with that user's own keys.  It is defined with
`torch.library.Library` rather than `torch.library.custom_op`, whose
Python wrapper costs each call several times the dispatcher's own host
time, and a decode step calls it once a layer.

A CUDA graph launches its kernels on replay without calling the
wrappers, so its capture takes the counts it made out of ``LAUNCHES``
(`launches_set_aside`) and every replay adds them back (`add_launches`):
a fused run counts what the eventful run of the same rounds counts.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (decode_splits,
                                                 flash_attention_cuda,
                                                 flash_attention_tc_cuda,
                                                 flash_decode_cuda,
                                                 flash_route, sm_count)
from repro_torch.kernels.mixing_aggregate import (
    N_MAX, mixing_aggregate_leaves_cuda)
from repro_torch.kernels.pairwise_sqdist import gram_sqdist_cuda
from repro_torch.kernels.quantize import (qsgd_dequantize_cuda,
                                          qsgd_encode_cuda,
                                          qsgd_roundtrip_cuda,
                                          rowwise_absmax_cuda)
from repro_torch.kernels.topk_threshold import topk_threshold_cuda

LAUNCHES: Dict[str, int] = {"mixing_aggregate": 0, "gram_matrix": 0,
                            "rowwise_absmax": 0, "qsgd_quantize": 0,
                            "qsgd_dequantize": 0, "qsgd_roundtrip": 0,
                            "topk_threshold": 0,
                            "flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_decode": 0}
# `flash_route`'s answer -> (the kernel's wrapper, its count in LAUNCHES)
FLASH_KERNELS = {"decode": (flash_decode_cuda, "flash_attention_decode"),
                 "tc": (flash_attention_tc_cuda, "flash_attention_tc"),
                 "cuda_core": (flash_attention_cuda, "flash_attention")}
FLASH_COUNTERS = {route: c for route, (_, c) in FLASH_KERNELS.items()}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def launches_set_aside() -> Iterator[Dict[str, int]]:
    """The counts made inside the block are taken out of ``LAUNCHES`` on
    leaving it and go into the dict it yields: a graph's capture (whose
    replays launch those kernels) or its warm-up (run once, outside the
    rounds a run counts)."""
    before = dict(LAUNCHES)
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        made.update({k: n - before[k] for k, n in LAUNCHES.items()
                     if n != before[k]})
        LAUNCHES.update(before)


def add_launches(counts: Dict[str, int]) -> None:
    """Add one replay's recorded counts to ``LAUNCHES``."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    """Whether ``t`` goes to the CUDA kernel; a CPU tensor goes to the
    plain version, and so does a ``meta`` one (the planner's: shapes
    only, no data)."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def mixing_aggregate_leaves(w: torch.Tensor,
                            thetas: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """[W Θ_l for each leaf]: w (k, m), thetas (m, D_l) of one dtype ->
    (k, D_l) each in that dtype, fp32 accumulation.  On CUDA one launch
    per N_MAX leaves, each element summed in the same order as a one-leaf
    call, so the two agree bit for bit."""
    if not _on_cuda(thetas[0], "mixing_aggregate"):
        return [ref.mixing_aggregate_ref(w, t) for t in thetas]
    outs = mixing_aggregate_leaves_cuda(w, thetas)
    LAUNCHES["mixing_aggregate"] += -(-len(thetas) // N_MAX)
    return outs


def mixing_aggregate(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Y = W Θ: w (k, m), theta (m, D) -> (k, D) in theta's dtype, fp32
    accumulation (the one-leaf case of `mixing_aggregate_leaves`)."""
    return mixing_aggregate_leaves(w, [theta])[0]


def _gram_sqdist(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    out = gram_sqdist_cuda(g.float().contiguous())
    LAUNCHES["gram_matrix"] += 1
    return out


def gram_matrix(g: torch.Tensor) -> torch.Tensor:
    """G = g gᵀ: (m, D) -> (m, m) float32."""
    if not _on_cuda(g, "gram_matrix"):
        return ref.gram_ref(g)
    return _gram_sqdist(g)[0]


def pairwise_sqdist(g: torch.Tensor) -> torch.Tensor:
    """Δ_ij = ||g_i − g_j||² via the Gram matrix: (m, D) -> (m, m) float32,
    bitwise `ref.sqdist_from_gram` of that Gram.  On CUDA the Gram and Δ
    come from one launch."""
    if not _on_cuda(g, "gram_matrix"):
        return ref.sqdist_from_gram(ref.gram_ref(g))
    return _gram_sqdist(g)[1]


def rowwise_absmax(x: torch.Tensor) -> torch.Tensor:
    """(m, D) f32 -> (m, 1) per-row max |x| (NaN rows give NaN)."""
    if not _on_cuda(x, "rowwise_absmax"):
        return ref.rowwise_absmax_ref(x)
    out = rowwise_absmax_cuda(x)
    LAUNCHES["rowwise_absmax"] += 1
    return out


def qsgd_quantize(x: torch.Tensor, noise: torch.Tensor, *, bits: int):
    """``(levels int32 (m, D), absmax (m, 1))`` of the QSGD codec; on CUDA
    one launch (the row pass: absmax, then levels from the same read)."""
    if not _on_cuda(x, "qsgd_quantize"):
        return ref.qsgd_quantize_ref(x, noise, bits)
    out = qsgd_encode_cuda(x, noise, bits)
    LAUNCHES["qsgd_quantize"] += 1
    return out


def qsgd_dequantize(q: torch.Tensor, absmax: torch.Tensor, *,
                    bits: int) -> torch.Tensor:
    """int32 levels (m, D) × per-row scale -> f32 values."""
    if not _on_cuda(q, "qsgd_dequantize"):
        return ref.qsgd_dequantize_ref(q, absmax, bits)
    out = qsgd_dequantize_cuda(q, absmax, bits)
    LAUNCHES["qsgd_dequantize"] += 1
    return out


def qsgd_roundtrip(x: torch.Tensor, noise: torch.Tensor, *,
                   bits: int) -> torch.Tensor:
    """dequantize(quantize(x)), what the server sees; on CUDA one launch
    (the row pass writes the values, neither levels nor absmax)."""
    if not _on_cuda(x, "qsgd_roundtrip"):
        return ref.qsgd_roundtrip_ref(x, noise, bits)
    out = qsgd_roundtrip_cuda(x, noise, bits)
    LAUNCHES["qsgd_roundtrip"] += 1
    return out


def topk_threshold(absx: torch.Tensor, *, k: int) -> torch.Tensor:
    """Per-row top-k magnitude cutoff (m, 1) of (m, D) magnitudes."""
    if not _on_cuda(absx, "topk_threshold"):
        return ref.topk_threshold_ref(absx, k)
    out = topk_threshold_cuda(absx, k)
    LAUNCHES["topk_threshold"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """Attention of q (B, H, Sq, dk) over k (B, Kh, Sk, dk) and v (B, Kh,
    Sk, dv) -> (B, H, Sq, dv), the logits scaled by 1/√dk, q aligned to
    the end of k, GQA by h // (H / Kh); causal, sliding window
    (k_pos > q_pos − window) and tanh logit softcap; under ``causal`` the
    keys below ``prefix_len`` are visible to every query (a prefix-LM's
    bidirectional prefix), the window still applying to them.  The value
    head dim dv may differ from dk (MLA's naive path: dk 192, dv 128).
    Strided
    views are taken as they are on CUDA; the output has q's dtype (and
    layout).  On CUDA, `flash_route` picks the kernel on (dk, dv):
    decode steps (Sq <= 16) on the split-key decode kernel, bf16 prefill
    at (64, 64), (80, 80), (128, 128), (192, 192), (256, 256) or (192,
    128) on the tensor cores, the other prefills on the CUDA cores.  Under
    `torch.func.vmap` one call serves the whole vmapped batch (module
    docstring), bitwise the per-user calls."""
    return _FLASH_OP(q, k, v, causal=causal, window=window, softcap=softcap,
                     prefix_len=prefix_len)


def _flash_cpu(q, k, v, *, causal=True, window=None, softcap=None,
               decode_rows=None, prefix_len=0):
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, prefix_len=prefix_len)


def _flash_cuda(q, k, v, *, causal=True, window=None, softcap=None,
                decode_rows=None, prefix_len=0):
    """``decode_rows``: the batch rows the decode kernel's split count is
    chosen for (default B): a vmapped call's are one user's, so each
    user's rows are summed as that user's own call sums them."""
    route = flash_route(q.dtype, q.shape[2], q.shape[3], v.shape[3])
    kernel, counter = FLASH_KERNELS[route]
    kw = {}
    if route == "decode" and decode_rows is not None:
        kw["n_split"] = decode_splits(decode_rows, k.shape[1], k.shape[2],
                                      sm_count(q.device))
    out = kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                 prefix_len=prefix_len, **kw)
    LAUNCHES[counter] += 1
    return out


def _fold(x: torch.Tensor, dim: Optional[int], n: int) -> torch.Tensor:
    """The vmapped dim ``dim`` of ``x`` (None: unbatched, so broadcast)
    moved to the front and folded into the batch dim: a view where the
    strides allow (the model's activations and caches)."""
    x = x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.flatten(0, 1)


def _flash_vmap(info, in_dims, q, k, v, *, causal=True, window=None,
                softcap=None, decode_rows=None, prefix_len=0):
    """The batching rule: (n, B, ...) inputs run as one (n·B, ...) call
    (v's own head dim dv rides along: only the leading dims fold)."""
    n = info.batch_size
    q, k, v = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims))
    if decode_rows is None:
        decode_rows = q.shape[0] // n
    out = _FLASH_OP(q, k, v, causal=causal, window=window, softcap=softcap,
                    decode_rows=decode_rows, prefix_len=prefix_len)
    return out.unflatten(0, (n, -1)), 0


_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, *, "
            "bool causal=True, int? window=None, float? softcap=None, "
            "int? decode_rows=None, int prefix_len=0) -> Tensor")
def _flash_meta(q, k, v, *, causal=True, window=None, softcap=None,
                decode_rows=None, prefix_len=0):
    """The planner's: the (B, H, Sq, dv) output's shape, no work."""
    return q.new_empty(tuple(q.shape[:3]) + (v.shape[3],))


def attn_pairs(sq: int, sk: int, causal: bool, window: Optional[int],
               prefix_len: int = 0) -> int:
    """The (query, key) pairs the flash contract's mask keeps: q aligned
    to the end of k, causal (the first ``prefix_len`` keys seen by every
    query) or full, and the window."""
    qp = np.arange(sk - sq, sk, dtype=np.int64)
    hi = np.minimum(np.maximum(qp, prefix_len - 1), sk - 1) if causal \
        else np.full_like(qp, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros_like(qp)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _flash_flops(q_shape, k_shape, v_shape, *, causal=True, window=None,
                 softcap=None, decode_rows=None, prefix_len=0,
                 out_shape=None, **_):
    """`torch.utils.flop_counter`'s formula: 2·(dk + dv) FLOP a kept
    (query, key) pair a head, the masked pairs not counted."""
    b, h, sq, dk = q_shape
    return 2 * (dk + v_shape[3]) * b * h * attn_pairs(
        sq, k_shape[2], causal, window, prefix_len)


_LIB.impl("flash_attention", _flash_cpu, "CPU")
_LIB.impl("flash_attention", _flash_cuda, "CUDA")
_LIB.impl("flash_attention", _flash_meta, "Meta")
torch.library.register_vmap("repro_torch::flash_attention", _flash_vmap,
                            lib=_LIB)
_FLASH_OP = torch.ops.repro_torch.flash_attention.default
register_flop_formula(torch.ops.repro_torch.flash_attention)(_flash_flops)


__all__ = ["FLASH_COUNTERS", "FLASH_KERNELS", "LAUNCHES", "add_launches",
           "attn_pairs", "flash_attention", "flash_route", "gram_matrix",
           "launches_set_aside", "mixing_aggregate",
           "mixing_aggregate_leaves",
           "pairwise_sqdist", "qsgd_dequantize", "qsgd_quantize",
           "qsgd_roundtrip", "ref", "reset_launches", "rowwise_absmax",
           "topk_threshold"]
