"""Distribution-similarity statistics (paper §III-A).

Counterpart of `repro/core/similarity.py` (`flatten_pytree`,
`delta_matrix`).  Δ_ij = ||ĝ_i − ĝ_j||² is a Gram-matrix computation over
the m flat client gradients; it runs through `kernels.ops.pairwise_sqdist`
(the hand-written Gram kernel on CUDA).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def flatten_pytree(tree) -> torch.Tensor:
    """Flat float32 vector of a param dict, leaves in sorted-key order (the
    order `jax.tree_util.tree_leaves` gives a dict)."""
    return torch.cat([tree[k].reshape(-1).float() for k in sorted(tree)])


def delta_matrix(grads: torch.Tensor) -> torch.Tensor:
    """Δ_ij = ||g_i − g_j||² from stacked gradients (m, D), via the Gram
    matrix: ||g_i||² + ||g_j||² − 2⟨g_i, g_j⟩, clamped at ≥ 0."""
    return ops.pairwise_sqdist(grads.float().contiguous())
