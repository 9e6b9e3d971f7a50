"""Self-attention with GQA, logit softcap, sliding windows and ring caches.

Counterpart of `repro/models/attention.py` for the dense decoder.  Every
layer's cache is a ring of ``C`` slots with an absolute-position array
(``pos``, -1 empty), as in the reference, and ``slot = pos % C``.  The
cache tensors are updated in place (the reference returns new arrays).

Sequences advance in lockstep, so a call takes the host-side position of
its first token, ``start``, instead of a (B, S) position array: the
reference's positions are ``start + arange(S)`` for every row.  Knowing it
on the host picks the keys without a device sync, and every attention
product with a cache goes through `kernels.ops.flash_attention`, whose
contract is that k holds contiguous positions 0..Sk−1 and q the last Sq
of them:

- S > C (a prefill longer than a sliding-window ring): the in-flight
  keys, as the reference does (`attention.py:257-264`); the ring keeps
  the tail;
- start + S <= C: slots 0..start+S−1 hold positions 0..start+S−1 in
  order, so the cache's first start+S slots (for a prefill from 0, the
  in-flight keys themselves);
- otherwise the ring has wrapped (one-token decode): every slot holds one
  of the last C positions, all within the window when C <= window, which
  is how `make_caches` sizes a windowed ring.  The kernel masks by
  position differences, so the whole ring in slot order (the reference's
  own order) is exact with no copy.  A ring longer than its window is
  rolled into chronological order first.

With no cache (training, and the full-sequence forward) attention is the
reference's own jnp path instead, `_sdpa_chunked` (causal, window,
softcap, GQA; q in chunks of ``Q_CHUNK``), written here in plain
differentiable torch ops that `torch.func.vmap` and `grad` take: the
reference trains through it, not through its flash kernel, and neither
flash kernel has a backward.

MLA, cross-attention, prefix-LM masks and sequence-parallel decode are
not ported here; they raise, naming their ROADMAP item.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_apply, dense_init,
                                       softcap)

LATER = "not ported yet: ROADMAP.md Queue 1 item 16b (LM path: the rest)"
NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor            # (B, C, Kh, hd)
    v: torch.Tensor            # (B, C, Kh, hd)
    pos: torch.Tensor          # (B, C) int32 absolute positions, -1 empty


def _dense_only(cfg: ModelConfig) -> None:
    a = cfg.attn
    if a.mla is not None:
        raise NotImplementedError(f"MLA attention is {LATER}")
    if a.seq_parallel:
        raise NotImplementedError(f"sequence-parallel decode is {LATER}")


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               device: DeviceLike = "cuda") -> KVCache:
    _dense_only(cfg)
    a, dev = cfg.attn, resolve_device(device)
    k = torch.zeros((batch, cache_len, a.n_kv_heads, a.head_dim),
                    dtype=dtype, device=dev)
    pos = torch.full((batch, cache_len), -1, dtype=torch.int32, device=dev)
    return KVCache(k, torch.zeros_like(k), pos)


def attn_init(gen: torch.Generator, cfg: ModelConfig, *, cross: bool = False,
              device: DeviceLike = "cuda"):
    """GQA projections wq (d, H, hd), wk and wv (d, Kh, hd), wo (H·hd, d),
    drawn in that order, plus zero ``q_scale``/``k_scale`` with qk_norm."""
    _dense_only(cfg)
    if cross:
        raise NotImplementedError(f"cross-attention is {LATER}")
    a, d, dt = cfg.attn, cfg.d_model, cfg.pdtype
    p = {
        "wq": dense_init(gen, d, (a.n_heads, a.head_dim), dt, device=device),
        "wk": dense_init(gen, d, (a.n_kv_heads, a.head_dim), dt,
                         device=device),
        "wv": dense_init(gen, d, (a.n_kv_heads, a.head_dim), dt,
                         device=device),
        "wo": dense_init(gen, a.n_heads * a.head_dim, d, dt, device=device),
    }
    if a.qk_norm:
        dev = resolve_device(device)
        p["q_scale"] = torch.zeros((a.head_dim,), dtype=dt, device=dev)
        p["k_scale"] = torch.zeros((a.head_dim,), dtype=dt, device=dev)
    return p


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + 1e-6)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# the no-cache path: masks and plain attention


def mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
              kind: str = "causal", window: Optional[int] = None,
              prefix_len: int = 0) -> torch.Tensor:
    """(..., Sq, Sk) f32 additive bias from absolute positions: 0 where a
    query may see a key, ``NEG_INF`` elsewhere.  kind: causal | full;
    ``window`` keeps k > q − window; ``prefix_len`` makes the first
    positions bidirectional; k_pos == −1 marks an empty slot."""
    q = q_pos[..., :, None].to(torch.int32)
    k = k_pos[..., None, :].to(torch.int32)
    valid = k >= 0
    if kind == "causal":
        ok = k <= q
        if prefix_len:
            ok = ok | (k < prefix_len)
        valid = valid & ok
    if window is not None:
        valid = valid & (k > q - window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def _sdpa(q, k, v, bias, cap, cdtype, *, scale=None):
    """q (B, Sq, H, hd), k and v (B, Sk, Kh, hd') with H % Kh == 0, bias
    (B, Sq, Sk).  Logits in f32 (the reference's
    ``preferred_element_type``), the probabilities in ``cdtype``."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    scale = (1.0 / math.sqrt(hd)) if scale is None else scale
    qg = q.reshape(b, sq, kh, h // kh, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale
    logits = softcap(logits, cap)
    logits = logits + bias[:, None, None, :, :]
    probs = torch.softmax(logits, dim=-1).to(cdtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(cdtype))
    return out.reshape(b, sq, h, v.shape[-1])


# q-chunked attention: live logits O(chunk · Sk) instead of O(Sq · Sk)
Q_CHUNK = 1024


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, kind: str, window, prefix_len,
                  cap, cdtype, scale=None, chunk: int = Q_CHUNK):
    """`_sdpa` with the masks built per q-chunk from positions.  q (B, Sq,
    H, hd); k, v (B, Sk, Kh, hd'); q_pos (B, Sq); k_pos (B, Sk).  The last
    chunk is padded at position 0 and cropped, as in the reference."""
    b, sq = q.shape[:2]
    if sq <= chunk:
        bias = mask_bias(q_pos, k_pos, kind=kind, window=window,
                         prefix_len=prefix_len)
        return _sdpa(q, k, v, bias, cap, cdtype, scale=scale)
    pad = (-sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = F.pad(q_pos, (0, pad))
    outs = []
    for c in range(q.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        bias = mask_bias(q_pos[:, sl], k_pos, kind=kind, window=window,
                         prefix_len=prefix_len)
        outs.append(_sdpa(q[:, sl], k, v, bias, cap, cdtype, scale=scale))
    return torch.cat(outs, dim=1)[:, :sq]


def _cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  start: int) -> KVCache:
    """Write positions start..start+S−1 at slot = pos % C, in place.

    S > C (a prefill longer than the ring): only the trailing C tokens
    survive; they fill the whole ring, rolled so that slot = pos % C holds
    for the decode writes that follow.  Otherwise the S slots from
    start % C must not run past the ring's end: a ring wraps only in
    one-token steps (the reference's lockstep serving design).
    """
    c = cache.pos.shape[1]
    s = k_new.shape[1]
    dev = cache.pos.device
    if s > c:
        first = start + s - c
        shift = first % c                   # slot of the oldest survivor
        pos = torch.arange(first, start + s, dtype=torch.int32, device=dev)
        for buf, new in ((cache.k, k_new[:, -c:]), (cache.v, v_new[:, -c:]),
                         (cache.pos, pos.expand(cache.pos.shape[0], c))):
            buf[:, shift:] = new[:, :c - shift]
            buf[:, :shift] = new[:, c - shift:]
        return cache
    slot = start % c
    if slot + s > c:
        raise ValueError(f"{s} positions from {start} wrap a ring of {c} "
                         "slots; only one-token steps may wrap")
    cache.k[:, slot:slot + s] = k_new
    cache.v[:, slot:slot + s] = v_new
    cache.pos[:, slot:slot + s] = torch.arange(start, start + s,
                                               dtype=torch.int32, device=dev)
    return cache


def _keys(cache: KVCache, k: torch.Tensor, v: torch.Tensor, start: int,
          window: Optional[int]):
    """The keys and values of the attention after ``_cache_update``, as
    contiguous positions ending at the last query (module docstring)."""
    c, s = cache.pos.shape[1], k.shape[1]
    if s > c:
        return k, v
    n = start + s
    if n <= c:
        return cache.k[:, :n], cache.v[:, :n]
    if window is None or c <= window:
        return cache.k, cache.v
    head = n % c                            # slot of the oldest position
    return (torch.cat([cache.k[:, head:], cache.k[:, :head]], dim=1),
            torch.cat([cache.v[:, head:], cache.v[:, :head]], dim=1))


def attention(params, cfg: ModelConfig, x: torch.Tensor, start: int, *,
              cache: Optional[KVCache] = None,
              window: Optional[int] = None,
              prefix_len: int = 0,
              kv_input: Optional[torch.Tensor] = None):
    """Causal self-attention of x (B, S, d) at positions start..start+S−1.
    Returns (out (B, S, d), cache) with the cache updated in place; with
    no cache, the plain `_sdpa_chunked` path (module docstring)."""
    a, cd = cfg.attn, cfg.cdtype
    _dense_only(cfg)
    if kv_input is not None:
        raise NotImplementedError(f"cross-attention (kv_input) is {LATER}")
    if prefix_len:
        raise NotImplementedError(f"prefix-LM masks (prefix_len) are {LATER}")
    b, s, _ = x.shape
    q = dense_apply(params["wq"], x, cd)                     # (B,S,H,hd)
    k = dense_apply(params["wk"], x, cd)                     # (B,S,Kh,hd)
    v = dense_apply(params["wv"], x, cd)
    if a.qk_norm:
        q = _rms(q, params["q_scale"])
        k = _rms(k, params["k_scale"])
    if cfg.pos_embedding == "rope":
        positions = torch.arange(start, start + s, device=x.device)
        q = apply_rope(q, positions, a.rope_theta, a.rope_fraction)
        k = apply_rope(k, positions, a.rope_theta, a.rope_fraction)
    if cache is None:
        pos = torch.arange(start, start + s, device=x.device).expand(b, s)
        out = _sdpa_chunked(q, k, v, pos, pos, kind="causal", window=window,
                            prefix_len=0, cap=a.attn_logit_softcap,
                            cdtype=cd)
        out = out.reshape(b, s, out.shape[2] * out.shape[3])
        return dense_apply(params["wo"], out, cd), None
    _cache_update(cache, k, v, start)
    k, v = _keys(cache, k, v, start, window)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2).to(cd),
                              v.transpose(1, 2).to(cd),
                              causal=True, window=window,
                              softcap=a.attn_logit_softcap)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return dense_apply(params["wo"], out, cd), cache
