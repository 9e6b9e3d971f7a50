"""Plain-PyTorch versions of the port's kernels (the allclose targets).

Counterpart of `repro/kernels/ref.py`.  The wrappers in `kernels/ops.py`
run these for tensors on the CPU; `chip_smoke.py` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def mixing_aggregate_ref(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Y = W Θ: (k, m) x (m, D) -> (k, D), fp32 accumulation, Θ's dtype."""
    return (w.float() @ theta.float()).to(theta.dtype)


def gram_ref(g: torch.Tensor) -> torch.Tensor:
    """G = g gᵀ in fp32: (m, D) -> (m, m)."""
    gf = g.float()
    return gf @ gf.T


def sqdist_from_gram(gram: torch.Tensor) -> torch.Tensor:
    """Δ_ij = G_ii + G_jj − 2 G_ij, clamped at ≥ 0 (exact zero diagonal)."""
    sq = torch.diagonal(gram)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)


def pairwise_sqdist_ref(g: torch.Tensor) -> torch.Tensor:
    """Δ_ij = ||g_i − g_j||², (m, D) -> (m, m) float32."""
    gf = g.float()
    sq = torch.sum(gf * gf, dim=1)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (gf @ gf.T),
                       min=0.0)


# ---------------------------------------------------------------------------
# channel codecs: QSGD and the top-k threshold (the reference's Pallas
# kernels in repro/kernels/quantize.py and topk_threshold.py; these repeat
# the kernels' f32 arithmetic op for op, so they agree bit for bit).  The
# reference's XLA runs flush subnormal values to 0; so do these, for QSGD's
# input elements and per-row scalars (absmax, scale, 1/scale) and for the
# bisection's midpoints.  Top-k reads its subnormal elements as they are:
# against a normal or zero threshold that gives the reference's mask.

TOPK_ITERS = 30         # bisection steps of the top-k threshold kernel
FLT_MIN = torch.finfo(torch.float32).tiny    # the smallest normal f32


def flush_subnormal(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its subnormal values replaced by 0 (NaN and inf kept)."""
    return torch.where(t.abs() < FLT_MIN, torch.zeros_like(t), t)


def qsgd_levels(bits: int):
    """``(s, 1/s)`` of a b-bit QSGD grid: s = 2^(b−1) − 1 as a float, and
    its reciprocal rounded to f32 once on the host (the reference's
    weakly-typed ``1.0 / levels``), as a 0-d float32 tensor."""
    if not 2 <= int(bits) <= 8:
        raise ValueError(f"qsgd bits must be in [2, 8], got {bits}")
    s = float(2 ** (int(bits) - 1) - 1)
    return s, torch.tensor(1.0 / s, dtype=torch.float32)


def rowwise_absmax_ref(x: torch.Tensor) -> torch.Tensor:
    """(m, D) -> (m, 1) per-row max |x|, a subnormal max flushed to 0 (the
    max of the elements read with subnormals as 0, as the reference's run
    reads them); a NaN anywhere in a row gives NaN (as ``jnp.max``)."""
    return flush_subnormal(x.abs().amax(dim=1, keepdim=True))


def qsgd_quantize_ref(x: torch.Tensor, noise: torch.Tensor, bits: int,
                      absmax: Optional[torch.Tensor] = None):
    """``(levels, absmax)``: int32 levels ``clip(floor(x·inv + u), −s, s)``
    with scale = absmax·(1/s) and inv = 1/scale (0 for an all-zero row),
    x's elements, absmax, scale and inv each flushed to 0 where subnormal,
    as the reference's run flushes them (a subnormal element gets level
    0, a row with a subnormal scalar crosses as zeros).  ``absmax`` given
    is used as is (the quantize kernel's own input).  A NaN level (a NaN
    or ±inf in the row) becomes 0, as XLA's and CUDA's float-to-int
    conversions give; PyTorch's CPU cast would give INT_MIN."""
    s, inv_s = qsgd_levels(bits)
    x = flush_subnormal(x)
    amax = rowwise_absmax_ref(x) if absmax is None else absmax
    scale = flush_subnormal(amax * inv_s.to(x.device))
    inv = torch.where(scale > 0, flush_subnormal(scale.reciprocal()),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.floor(x * inv + noise), -s, s)
    return torch.nan_to_num(q, nan=0.0).to(torch.int32), amax


def qsgd_dequantize_ref(q: torch.Tensor, absmax: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """float(q) · (absmax·(1/s)), the scale flushed to 0 where subnormal:
    (m, D) int32 -> (m, D) f32."""
    _, inv_s = qsgd_levels(bits)
    return q.to(torch.float32) * flush_subnormal(
        absmax * inv_s.to(absmax.device))


def qsgd_roundtrip_ref(x: torch.Tensor, noise: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """dequantize(quantize(x)): the values the server sees."""
    q, amax = qsgd_quantize_ref(x, noise, bits)
    return qsgd_dequantize_ref(q, amax, bits)


def topk_threshold_ref(absx: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row top-k cutoff by the kernel's 30 f32 bisection steps over
    [0, max]: (m, D) magnitudes -> (m, 1) with count(absx >= t) >= k.  It
    lands at most one ulp below the exact k-th value; k > D leaves 0.  A
    subnormal midpoint is flushed to 0, as the reference's run flushes
    it (so a k-th value below the normal range gives 0)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    hi = absx.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(TOPK_ITERS):
        mid = flush_subnormal(0.5 * (lo + hi))
        ge = (absx >= mid).sum(dim=1, keepdim=True) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return lo


def topk_threshold_tree_ref(absx: torch.Tensor, k: int,
                            levels: int) -> torch.Tensor:
    """`topk_threshold_ref`'s function computed as the CUDA kernel
    computes it: the 30 steps taken ``levels`` at a time.  A pass forms
    the tree of the next L = min(levels, steps left) steps' candidates in
    heap order (node n's midpoint 0.5·(lo_n + hi_n), flushed to 0 where
    subnormal; its child 2n, for
    count < k, takes hi = mid, its child 2n + 1 takes lo = mid), counts
    every candidate in one pass over the row, then walks down the tree
    with the sequential rule.  Each midpoint is the same f32 expression
    of the same lo and hi, so the result is bitwise the sequential one."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if int(levels) < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    hi = absx.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    done = 0
    while done < TOPK_ITERS:
        n_lv = min(int(levels), TOPK_ITERS - done)
        n_nodes = 2 ** n_lv - 1
        nlo, nhi = {1: lo}, {1: hi}
        mids = []
        for nd in range(1, n_nodes + 1):
            mid = flush_subnormal(0.5 * (nlo[nd] + nhi[nd]))
            mids.append(mid)
            if 2 * nd <= n_nodes:
                nlo[2 * nd], nhi[2 * nd] = nlo[nd], mid
                nlo[2 * nd + 1], nhi[2 * nd + 1] = mid, nhi[nd]
        mid = torch.cat(mids, dim=1)                          # (m, nodes)
        count = (absx[:, None, :] >= mid[:, :, None]).sum(-1)
        node = torch.ones_like(hi, dtype=torch.int64)         # heap index
        for _ in range(n_lv):
            m_n = mid.gather(1, node - 1)
            ge = count.gather(1, node - 1) >= k
            lo, hi = torch.where(ge, m_n, lo), torch.where(ge, hi, m_n)
            node = 2 * node + ge.long()
        done += n_lv
    return lo


# ---------------------------------------------------------------------------
# attention (the reference's Pallas kernel in repro/kernels/flash_attention.py)

NEG_INF = -1e30


def _logits(q: torch.Tensor, k: torch.Tensor, causal: bool,
            window: Optional[int], softcap: Optional[float]):
    """The (B, Kh, G, Sq, Sk) f32 logits, scaled and capped, and the
    (Sq, Sk) mask of valid keys (q aligned to the end of k)."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, sq, hd).float()
    logits = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float())
    logits.div_(math.sqrt(hd))
    if softcap is not None:
        logits.div_(softcap).tanh_().mul_(softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos <= q_pos
    if window is not None:
        valid &= k_pos > q_pos - window
    return logits, valid


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain SDPA: q (B, H, Sq, dk), k (B, Kh, Sk, dk) and v (B, Kh, Sk,
    dv), GQA group G = H / Kh, q aligned to the end of k; logits scaled by
    1/√dk, f32 logits and softmax, output (B, H, Sq, dv) in q's dtype.  A
    query row with no valid key (causal with Sq > Sk: the first Sq − Sk
    rows) comes out 0, as the Pallas kernel's guards give it.  The (B, Kh,
    G, Sq, Sk) logits are materialised, once."""
    b, h, sq = q.shape[:3]
    logits, valid = _logits(q, k, causal, window, softcap)
    logits.masked_fill_(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    out.masked_fill_(~valid.any(-1)[:, None], 0.0)
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     n_split: int, causal: bool = True,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """`flash_attention_ref`'s function computed as the decode kernel
    computes it: the keys cut into ``n_split`` contiguous ranges of
    ``ceil(Sk / n_split)`` (the last ones may be short or empty); per
    range the row max m (NEG_INF when nothing is valid), l = Σ p and
    acc = Σ p·v with p = exp(s − m_safe) on valid keys; then the merge
    w_s = exp(m_s − m*_safe) (0 for a masked range), out = Σ w_s·acc_s /
    max(Σ w_s·l_s, 1e-30).  A row with no valid key comes out 0.  v may
    have its own head dim dv, as in `flash_attention_ref`."""
    if int(n_split) < 1:
        raise ValueError(f"n_split must be >= 1, got {n_split}")
    b, h, sq = q.shape[:3]
    dv = v.shape[-1]
    kh, sk = k.shape[1], k.shape[2]
    chunk = -(-sk // n_split)
    pad = n_split * chunk - sk
    logits, valid = _logits(q, k, causal, window, softcap)
    logits = torch.nn.functional.pad(logits, (0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))      # pads False
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    s = logits.reshape(b, kh, h // kh, sq, n_split, chunk)
    ok = valid.reshape(sq, n_split, chunk)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(-1)                                   # (b, kh, g, sq, n)
    m_safe = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.where(ok, torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l_s = p.sum(-1)
    acc = torch.einsum("bkgqnc,bkncd->bkgqnd", p,
                       vf.reshape(b, kh, n_split, chunk, dv))
    m_star = m.amax(-1, keepdim=True)
    m_star = torch.where(m_star <= NEG_INF, torch.zeros_like(m_star), m_star)
    w = torch.where(m <= NEG_INF, torch.zeros_like(m), torch.exp(m - m_star))
    l = (w * l_s).sum(-1)
    out = (w[..., None] * acc).sum(-2) / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, sq, dv).to(q.dtype)
