"""User-centric aggregation (paper Eq. 5) over client-stacked param dicts.

Counterpart of `repro/core/aggregation.py` (`mix_pytree`,
`user_centric_aggregate`, `stream_aggregate`).  Every leaf carries a
leading client dim m; the mix is one `kernels.ops.mixing_aggregate` call
per leaf on ``leaf.reshape(m, -1)`` — on CUDA, one launch of the
hand-written Y = W Θ kernel per leaf (10 a round for LeNet-5):

    θ_i = Σ_j W[i,j] θ_j                     (unicast / full personalization)
    θ̂_c = Σ_j Ŵ[c,j] θ_j ; θ_i = θ̂_{a(i)}   (k streams, group broadcast)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.streams import StreamPlan
from repro_torch.kernels import ops


def _mix_leaf(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(k, m) x (m, ...) -> (k, ...) in the leaf's dtype, fp32 accumulation.
    W is rounded to the leaf's dtype first, as the reference does, so bf16
    leaves mix with bf16-rounded weights."""
    m = leaf.shape[0]
    out = ops.mixing_aggregate(w.to(leaf.dtype), leaf.reshape(m, -1))
    return out.reshape((w.shape[0],) + tuple(leaf.shape[1:]))


def mix_pytree(stacked: Dict[str, torch.Tensor],
               w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Apply an aggregation-rule matrix w (k, m) to all leaves (m, ...)."""
    return {name: _mix_leaf(w, leaf) for name, leaf in stacked.items()}


def user_centric_aggregate(stacked, w: torch.Tensor):
    """Full personalization: every client gets its own mixed model (m -> m)."""
    return mix_pytree(stacked, w)


def stream_aggregate(stacked, plan: StreamPlan):
    """k-stream aggregation: mix to the k centroids, then gather each
    client's row by ``plan.assignment`` (group broadcast)."""
    mixed = mix_pytree(stacked, plan.centroids)
    return {name: leaf[plan.assignment] for name, leaf in mixed.items()}
