"""Plain-PyTorch versions of the port's kernels (the allclose targets).

Counterpart of `repro/kernels/ref.py`.  The wrappers in `kernels/ops.py`
run these for tensors on the CPU; `chip_smoke.py` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

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
