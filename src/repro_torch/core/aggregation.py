"""User-centric aggregation (paper Eq. 5) over client-stacked param dicts.

Counterpart of `repro/core/aggregation.py` (`mix_pytree`,
`user_centric_aggregate`, `fedavg_aggregate`, `stream_aggregate`,
`downlink_models`).  Every leaf carries a
leading client dim m; the mix is one `kernels.ops.mixing_aggregate_leaves`
call per leaf dtype over ``leaf.reshape(m, -1)`` — on CUDA, one launch of
the hand-written Y = W Θ kernel for the whole tree (one a round for
LeNet-5's ten leaves):

    θ_i = Σ_j W[i,j] θ_j                     (unicast / full personalization)
    θ̂_c = Σ_j Ŵ[c,j] θ_j ; θ_i = θ̂_{a(i)}   (k streams, group broadcast)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.streams import StreamPlan
from repro_torch.kernels import ops


def mix_pytree(stacked: Dict[str, torch.Tensor],
               w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Apply an aggregation-rule matrix w (k, m) to all leaves (m, ...):
    (k, ...) in each leaf's dtype, fp32 accumulation.  W is rounded to a
    leaf's dtype first, as the reference does, so bf16 leaves mix with
    bf16-rounded weights.  Leaves go to the op in sorted-key order, one
    call per dtype; a strided leaf (a column block of a flat (m, D) view,
    as the fault injector and the defense hand back) is made contiguous
    first, since the kernel reads rows of the leaf's own width."""
    groups: Dict[torch.dtype, list] = {}
    for name in sorted(stacked):
        groups.setdefault(stacked[name].dtype, []).append(name)
    mixed = {}
    for dtype, names in groups.items():
        leaves = [stacked[n] for n in names]
        outs = ops.mixing_aggregate_leaves(
            w.to(dtype),
            [v.reshape(v.shape[0], -1).contiguous() for v in leaves])
        for n, v, y in zip(names, leaves, outs):
            mixed[n] = y.reshape((w.shape[0],) + tuple(v.shape[1:]))
    return {name: mixed[name] for name in stacked}


def user_centric_aggregate(stacked, w: torch.Tensor):
    """Full personalization: every client gets its own mixed model (m -> m)."""
    return mix_pytree(stacked, w)


def fedavg_aggregate(stacked, n: torch.Tensor):
    """FedAvg: one weighted mean, broadcast back to all m clients (the
    (m, m) rule with every row n / Σn, one mix)."""
    m = n.shape[0]
    w = (n / n.sum())[None, :].expand(m, m).contiguous()
    return mix_pytree(stacked, w)


def stream_aggregate(stacked, plan: StreamPlan):
    """k-stream aggregation: client i gets stream a(i)'s mix, here as one
    mix with the (m, m) rule ``centroids[assignment]`` — the same function
    as mixing to the k centroids and gathering rows (group broadcast), in
    one launch and with no per-leaf gather."""
    return mix_pytree(stacked, plan.centroids[plan.assignment])


def downlink_models(w_or_plan) -> int:
    """Number of distinct models the PS must transmit (comm-model input):
    a `StreamPlan`'s k, else the rows of a mixing matrix."""
    if isinstance(w_or_plan, StreamPlan):
        return int(w_or_plan.centroids.shape[0])
    return int(w_or_plan.shape[0])
