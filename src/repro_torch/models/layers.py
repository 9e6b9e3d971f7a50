"""Building blocks of the LM path: dense layers, norms, activations, MLPs,
embeddings, RoPE and the logit softcap.

Counterpart of `repro/models/layers.py`, over the same parameter dicts and
layouts: a dense weight is ``(d_in, *d_out)`` and contracts x's last dim.
Params are stored in the param dtype and cast to the compute dtype at use;
norm statistics and RoPE run in f32.  ``*_init`` draw from an explicit
`torch.Generator` that lives on ``device``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


def vmapped(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a `torch.func.vmap` batch dim (a functorch
    batched tensor): a write into a tensor made inside the vmapped
    function, which carries none, must then go out of place."""
    return torch._C._functorch.is_batchedtensor(t)


# ---------------------------------------------------------------------------
# initializers


def normal_init(gen: torch.Generator, shape, dtype, stddev: float,
                device: DeviceLike) -> torch.Tensor:
    """N(0, stddev²) of ``shape`` drawn in f32, stored in ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=resolve_device(device))
    return x.mul_(stddev).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out, dtype, *,
               scale: float = 1.0, device: DeviceLike = "cuda"
               ) -> torch.Tensor:
    """Fan-in scaled normal; ``d_out`` may be a tuple (fused heads)."""
    shape = (d_in,) + (tuple(d_out) if isinstance(d_out, tuple) else (d_out,))
    return normal_init(gen, shape, dtype, scale / math.sqrt(d_in), device)


def dense_apply(w: torch.Tensor, x: torch.Tensor, cdtype) -> torch.Tensor:
    """x @ w where w may have > 2 dims: (d_in, a, b, ...) contracts x's
    last dim; computed and returned in ``cdtype``."""
    return torch.tensordot(x.to(cdtype), w.to(cdtype), dims=([x.dim() - 1],
                                                            [0]))


# ---------------------------------------------------------------------------
# norms


def norm_init(kind: str, dim: int, dtype, device: DeviceLike = "cuda"):
    dev = resolve_device(device)
    if kind == "rmsnorm":       # gemma-style (1 + scale)
        return {"scale": torch.zeros((dim,), dtype=dtype, device=dev)}
    if kind == "layernorm":
        return {"scale": torch.ones((dim,), dtype=dtype, device=dev),
                "bias": torch.zeros((dim,), dtype=dtype, device=dev)}
    raise ValueError(kind)


def norm_apply(kind: str, params, x: torch.Tensor, cdtype) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
        y = y * (1.0 + params["scale"].float())
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(kind)
    return y.to(cdtype)


# ---------------------------------------------------------------------------
# activations and MLP


def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind in ("geglu", "gelu"):     # geglu's gated branch is tanh-gelu
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":               # squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype, device: DeviceLike = "cuda"):
    p = {"up": dense_init(gen, d_model, d_ff, dtype, device=device),
         "down": dense_init(gen, d_ff, d_model, dtype, device=device)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, dtype, device=device)
    return p


def mlp_apply(params, x: torch.Tensor, act: str, cdtype) -> torch.Tensor:
    up = dense_apply(params["up"], x, cdtype)
    if "gate" in params:
        h = activation(act, dense_apply(params["gate"], x, cdtype)) * up
    else:
        h = activation(act, up)
    return dense_apply(params["down"], h, cdtype)


# ---------------------------------------------------------------------------
# embeddings and positions


def embedding_init(gen: torch.Generator, vocab: int, dim: int, dtype,
                   device: DeviceLike = "cuda") -> torch.Tensor:
    return normal_init(gen, (vocab, dim), dtype, 1.0 / math.sqrt(dim), device)


def embedding_lookup(table: torch.Tensor, tokens: torch.Tensor,
                     cdtype) -> torch.Tensor:
    return table[tokens].to(cdtype)


def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device: DeviceLike = "cpu"
                     ) -> Tuple[torch.Tensor, int]:
    """(inverse frequencies (rot_dim/2,) f32, rot_dim)."""
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    idx = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                       device=resolve_device(device))
    return 1.0 / (theta ** (idx / rot_dim)), rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    inv, rot_dim = rope_frequencies(head_dim, theta, fraction, x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., None].float() * inv               # (..., s, rot/2)
    sin = torch.sin(ang)[..., None, :]                     # (..., s, 1, rot/2)
    cos = torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., : rot_dim // 2].float(), xr[..., rot_dim // 2:].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1.to(x.dtype), r2.to(x.dtype)], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot_dim < head_dim else out


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
