"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Counterpart of `repro/models/ssm.py`, over the same parameter dicts and
caches.  Training and prefill run the chunked SSD algorithm: attention-
like products inside each chunk of ``chunk_size`` positions, and a linear
recurrence of the (h, p, n) state across the chunks (the reference's
``lax.scan``, a Python loop over the chunks here).  A decode step is the
O(1) state update `ssd_decode_step`, chosen by the ``decode`` flag, not
`ssd_scan` at S 1: the two round differently.  The reference's SSD is
plain jnp (no Pallas kernel), so this module is plain PyTorch: its
products are `torch.einsum` / `torch.matmul` in f32, differentiable under
`torch.func.vmap(grad(...))`.

Numerics kept from the reference:

- the depthwise causal conv sums its K taps in order (Python's ``sum``),
  in the common dtype of the carry and the input: an f32 cache with
  bf16 activations convolves in f32; with no cache (training) the zero
  carry takes the input's dtype;
- ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it
  (`torch.nn.functional.softplus` switches to x above 20);
- ``A_log``, ``D`` and ``dt_bias`` are f32 in every config (a bf16
  config's other leaves are bf16), and the scan and the decode step run
  in f32;
- the new state is cast to the cache's dtype: the port's `generate`
  makes its caches in the compute dtype, as the reference's step
  builders do, so in a bf16 config the state rounds to bf16 every token.

`_segsum` masks the upper triangle to -inf before the ``exp`` where the
reference takes ``exp`` of the whole (c, c) difference and then masks:
the forward's bits are the same (``exp(-inf)`` is 0), but at the
published chunk of 256 the reference's masked entries can overflow to
inf and a gradient through them is inf·0 (ROADMAP Queue 3), which the
masked form never forms.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import dense_apply, dense_init


class SSMCache(NamedTuple):
    conv: torch.Tensor     # (B, d_conv - 1, conv_dim) trailing conv inputs
    state: torch.Tensor    # (B, nh, head_dim, d_state)


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, n_heads, conv_dim)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_dim


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device: DeviceLike = "cuda") -> SSMCache:
    s, dev = cfg.ssm, resolve_device(device)
    _, nh, conv_dim = ssm_dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                         device=dev),
        state=torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype,
                          device=dev))


def ssm_init(gen: torch.Generator, cfg: ModelConfig,
             device: DeviceLike = "cuda"):
    """in_proj (d, 2·d_inner + 2·groups·d_state + nh: [z, xBC, dt]),
    conv_w (d_conv, conv_dim), then dt_bias (the inverse softplus of a dt
    drawn log-uniform in [dt_min, dt_max]) and out_proj (d_inner, d),
    drawn in that order; A_log = log(linspace(1, 16, nh)), D = 1,
    dt_bias, A_log and D in f32, the rest in the param dtype."""
    s, d, dt = cfg.ssm, cfg.d_model, cfg.pdtype
    dev = resolve_device(device)
    d_inner, nh, conv_dim = ssm_dims(cfg)
    d_proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
    in_proj = dense_init(gen, d, d_proj, dt, device=dev)
    conv_w = (torch.randn((s.d_conv, conv_dim), generator=gen,
                          dtype=torch.float32, device=dev)
              / math.sqrt(s.d_conv)).to(dt)
    u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=dev)
    dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                    + math.log(s.dt_min))
    dt_bias = torch.log(torch.exp(dt0) - 1.0 + 1e-9)
    out_proj = dense_init(gen, d_inner, d, dt, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm_scale": torch.zeros((d_inner,), dtype=dt, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv + SiLU.  x (B, S, C); w (K, C); carry (B,
    K−1, C) the previous inputs (None: zeros in x's dtype).  The carry and
    x are joined in their common dtype, the taps summed in order.
    Returns (out, the new carry: the last K−1 inputs)."""
    k = w.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    dtype = torch.promote_types(carry.dtype, x.dtype)
    xp = torch.cat([carry.to(dtype), x.to(dtype)], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    new_carry = xp[:, -(k - 1):, :] if k > 1 else carry
    return F.silu(out + b[None, None, :]), new_carry


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., c, h) -> L (..., h, c, c), L[i, j] = exp(sum_{j<k<=i}
    dA_k) for i >= j, else 0 (masked before the exp: module docstring)."""
    cs = torch.cumsum(dA, dim=-2).movedim(-1, -2)             # (..., h, c)
    diff = cs[..., :, None] - cs[..., None, :]                # (..., h, c, c)
    c = dA.shape[-2]
    mask = torch.ones((c, c), dtype=torch.bool, device=dA.device).tril()
    return torch.exp(diff.masked_fill(~mask, -math.inf))


def _pad_seq(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` (b, s, ...) with ``pad`` zero positions appended."""
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                     dim=1)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x (b, s, h, p); dt (b, s, h); A (h,); B, C (b, s, g,
    n).  Returns (y (b, s, h, p), the final state (b, h, p, n)), all in
    f32.  S not a multiple of the chunk is zero-padded (dt 0: the padded
    positions leave the state alone) and cropped."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        x, dt, B, C = (_pad_seq(a, pad) for a in (x, dt, B, C))
    nc = x.shape[1] // c
    xr = x.reshape(b, nc, c, h, p).float()
    dtr = dt.reshape(b, nc, c, h).float()
    Br = B.reshape(b, nc, c, g, n).float()
    Cr = C.reshape(b, nc, c, g, n).float()

    dA = dtr * A[None, None, None, :]                         # (b,nc,c,h)
    xdt = xr * dtr[..., None]                                 # (b,nc,c,h,p)
    L = _segsum(dA)                                           # (b,nc,h,c,c)
    # intra-chunk: Y[i] = sum_{j<=i} (C_i . B_j) L_ij xdt_j, the
    # reference's einsum "bligj,blgkij,bljgkp->bligkp" as the product of
    # the first two, then a contraction over j
    xg = xdt.reshape(b, nc, c, g, hg, p)
    Lg = L.reshape(b, nc, g, hg, c, c)                        # b l g k i j
    cb = torch.einsum("blign,bljgn->bligj", Cr, Br)           # (b,nc,c,g,c)
    w = Lg * cb.permute(0, 1, 3, 2, 4)[:, :, :, None]         # b l g k i j
    y_diag = torch.matmul(w, xg.permute(0, 1, 3, 4, 2, 5))    # b l g k i p
    y_diag = y_diag.permute(0, 1, 4, 2, 3, 5).reshape(b, nc, c, h, p)

    # chunk states: S_l = sum_j exp(cs_last - cs_j) xdt_j B_j^T, the
    # reference's "blcgk,blcgkp,blcgn->blgkpn" with the decay folded in
    cs = torch.cumsum(dA, dim=2)
    decay = torch.exp(cs[:, :, -1:, :] - cs)                  # (b,nc,c,h)
    decay_g = decay.reshape(b, nc, c, g, hg)
    states = torch.einsum("blcgkp,blcgn->blgkpn", decay_g[..., None] * xg,
                          Br).reshape(b, nc, h, p, n)

    # inter-chunk recurrence, the state before each chunk kept
    chunk_decay = torch.exp(dA.sum(dim=2))                    # (b,nc,h)
    carry = (torch.zeros_like(states[:, 0]) if init_state is None
             else init_state.float())
    prev = []
    for l in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, l, :, None, None] + states[:, l]
    prev_states = torch.stack(prev, dim=1)                    # (b,nc,h,p,n)

    # inter-chunk output: Y_off[i] = exp(cs_i) C_i . S_prev
    pg = prev_states.reshape(b, nc, g, hg, p, n)
    y_off = torch.einsum("blign,blgkpn->bligkp", Cr, pg)
    y_off = y_off.reshape(b, nc, c, h, p) * torch.exp(cs)[..., None]
    y = (y_diag + y_off).reshape(b, nc * c, h, p)
    if pad:
        y = y[:, :s]
    return y, carry


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's state update.  x (b, h, p); dt (b, h); B, C (b, g, n);
    state (b, h, p, n) -> (y (b, h, p), the new state), in f32."""
    h = x.shape[1]
    hg = h // B.shape[1]
    dA = torch.exp(dt.float() * A[None, :])                   # (b,h)
    xdt = (x * dt[..., None]).float()
    Bh = B.float().repeat_interleave(hg, dim=1)               # (b,h,n)
    Ch = C.float().repeat_interleave(hg, dim=1)
    new_state = state.float() * dA[..., None, None] \
        + xdt[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * (1.0 + scale.float())


def ssm_apply(params, cfg: ModelConfig, x: torch.Tensor,
              cache: Optional[SSMCache] = None, *, decode: bool = False
              ) -> Tuple[torch.Tensor, SSMCache]:
    """The Mamba2 block.  x (B, S, d) -> (y (B, S, d), the new cache): a
    new `SSMCache` (the tensors are not updated in place), its state in
    the given cache's dtype (f32 with no cache).  ``decode`` (S 1, a
    cache) takes the one-token state update."""
    s, cd = cfg.ssm, cfg.cdtype
    d_inner, nh, conv_dim = ssm_dims(cfg)
    b, sl, _ = x.shape
    proj = dense_apply(params["in_proj"], x, cd)
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:d_inner + conv_dim]
    dt_raw = proj[..., d_inner + conv_dim:]
    xBC, new_conv = _causal_conv(xBC, params["conv_w"].to(cd),
                                 params["conv_b"].to(cd),
                                 cache.conv if cache is not None else None)
    gn = s.n_groups * s.d_state
    xs = xBC[..., :d_inner]
    Bc = xBC[..., d_inner:d_inner + gn].reshape(b, sl, s.n_groups, s.d_state)
    Cc = xBC[..., d_inner + gn:].reshape(b, sl, s.n_groups, s.d_state)
    dt = dt_raw.float() + params["dt_bias"][None, None, :]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))      # jax.nn.softplus
    A = -torch.exp(params["A_log"])
    xh = xs.reshape(b, sl, nh, s.head_dim)

    if decode:
        if sl != 1 or cache is None:
            raise ValueError(f"a decode step takes one token and a cache, "
                             f"got S={sl}, cache {cache is not None}")
        y, new_state = ssd_decode_step(xh[:, 0].float(), dt[:, 0], A,
                                       Bc[:, 0], Cc[:, 0], cache.state)
        y = y[:, None]
    else:
        init = cache.state if cache is not None else None
        y, new_state = ssd_scan(xh, dt, A, Bc, Cc, s.chunk_size, init)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, sl, d_inner)
    y = _gated_rmsnorm(y, z, params["norm_scale"]).to(cd)
    out = dense_apply(params["out_proj"], y, cd)
    state_dtype = cache.state.dtype if cache is not None else torch.float32
    return out, SSMCache(conv=new_conv, state=new_state.to(state_dtype))
