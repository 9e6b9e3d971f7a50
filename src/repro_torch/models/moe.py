"""Mixture-of-Experts: top-k routing with GShard-style capacity dispatch.

Counterpart of `repro/models/moe.py` (`moe_init`, `_dispatch_tensors`,
`moe_apply`).  Token groups of ``group_size`` bound the dispatch one-hot
to (G, gs, E, C) with C = ceil(gs · top_k · capacity_factor / E); slot j's
choices queue behind slot j−1's in each expert's buffer, tokens over
capacity are dropped, and the Switch load-balance loss is the aux.  The
dispatch, the experts and the combine are `torch.einsum`s in the compute
dtype, as the reference leaves them to XLA outside any Pallas kernel.

Two rules of the reference are kept by hand:

- ``jax.lax.top_k`` puts the lower index first among equal values, and
  ties are real here: the zero rows that pad the last token group route
  uniformly, and their slot-0 choices take capacity ahead of real
  tokens' slot-1 choices.  `_top_k` is a stable descending sort, so it
  breaks ties the same way (``torch.topk`` promises no order);
- ``jax.nn.one_hot(i, n)`` is a zero row for i >= n (a position past an
  expert's capacity), where ``F.one_hot`` raises: `_one_hot` compares.

Nothing reads a value back to the host and nothing writes in place, so
`moe_apply` runs under `torch.func.vmap` (a served user's tokens are its
own groups) and ``vmap(grad(...))`` (training).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.layers import (activation, dense_apply, mlp_apply,
                                       mlp_init, normal_init)


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Router (d, E), experts w_gate and w_up (E, d, d_expert) and w_down
    (E, d_expert, d), fan-in scaled, drawn in that order, then the shared
    experts' MLP where the config has them."""
    m = cfg.moe
    d, dt = cfg.d_model, cfg.pdtype
    s = 1.0 / math.sqrt(d)
    experts = (m.n_experts, d, m.d_expert)
    p = {
        "router": normal_init(gen, (d, m.n_experts), dt, s, device),
        "w_gate": normal_init(gen, experts, dt, s, device),
        "w_up": normal_init(gen, experts, dt, s, device),
        "w_down": normal_init(gen, (m.n_experts, m.d_expert, d), dt,
                              1.0 / math.sqrt(m.d_expert), device),
    }
    if m.n_shared_experts:
        p["shared"] = mlp_init(gen, d, m.n_shared_experts * m.d_expert,
                               cfg.gated_mlp, dt, device)
    return p


def _one_hot(i: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: (..., n), a zero row where i is out of range."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_tensors(gates: torch.Tensor, idx: torch.Tensor,
                      n_experts: int, capacity: int, cdtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard top-k dispatch.  gates, idx: (G, gs, k).  Returns dispatch
    (G, gs, E, C) in ``cdtype`` and combine (G, gs, E, C) in f32; a
    token's place in its expert's buffer counts the tokens ahead of it in
    its slot and every token of the slots before."""
    g, _, k = idx.shape
    base_count = torch.zeros((g, n_experts), dtype=torch.int64,
                             device=idx.device)
    dispatch = None
    combine = None
    for j in range(k):
        onehot = _one_hot(idx[..., j], n_experts, torch.int64)   # (G,gs,E)
        prio = torch.cumsum(onehot, dim=1) - onehot         # tokens ahead
        pos = prio + base_count[:, None, :]
        keep = (onehot > 0) & (pos < capacity)
        sel = keep.to(torch.float32)[..., None] * _one_hot(
            pos, capacity, torch.float32)                   # (G,gs,E,C)
        term = gates[..., j][..., None, None].float() * sel
        dispatch = sel > 0 if dispatch is None else dispatch | (sel > 0)
        combine = term if combine is None else combine + term
        base_count = base_count + onehot.sum(dim=1)
    return dispatch.to(cdtype), combine


def moe_apply(params: Dict[str, Any], cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in the compute dtype, aux f32 scalar)."""
    m, cd = cfg.moe, cfg.cdtype
    b, s, d = x.shape
    n_tok = b * s
    gs = min(m.group_size, n_tok)
    pad = (-n_tok) % gs
    xt = x.reshape(n_tok, d)
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, d))], dim=0)
    xg = xt.reshape(-1, gs, d)                               # (G, gs, d)

    logits = dense_apply(params["router"], xg, torch.float32)  # (G,gs,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, m.top_k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    capacity = max(1, math.ceil(gs * m.top_k * m.capacity_factor
                                / m.n_experts))
    dispatch, combine = _dispatch_tensors(gates, idx, m.n_experts, capacity,
                                          cd)

    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg.to(cd))  # (G,E,C,d)
    up = torch.einsum("gecd,edf->gecf", xe, params["w_up"].to(cd))
    if cfg.gated_mlp:
        gate = torch.einsum("gecd,edf->gecf", xe, params["w_gate"].to(cd))
        h = activation(cfg.activation, gate) * up
    else:
        h = activation(cfg.activation, up)
    ye = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(cd))
    y = torch.einsum("gsec,gecd->gsd", combine.to(cd), ye)
    y = y.reshape(-1, d)[:n_tok].reshape(b, s, d)

    # Switch-style load-balance aux loss: E · Σ_e f_e · p_e
    frac_routed = _one_hot(idx, m.n_experts, torch.float32).sum(
        dim=2).mean(dim=(0, 1)) / m.top_k                    # (E,)
    mean_prob = probs.mean(dim=(0, 1))
    aux = m.n_experts * (frac_routed * mean_prob).sum() * m.router_aux_coef

    if m.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg.activation, cd)
    return y, aux
