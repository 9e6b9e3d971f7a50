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
    assert ops.LAUNCHES["mixing_aggregate"] == rounds * n_leaves
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.mixing_aggregate import mixing_aggregate_cuda
from repro_torch.kernels.pairwise_sqdist import gram_matrix_cuda

LAUNCHES: Dict[str, int] = {"mixing_aggregate": 0, "gram_matrix": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: unsupported device {t.device}")


def mixing_aggregate(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Y = W Θ: w (k, m), theta (m, D) -> (k, D) in theta's dtype, fp32
    accumulation."""
    if not _on_cuda(theta, "mixing_aggregate"):
        return ref.mixing_aggregate_ref(w, theta)
    out = mixing_aggregate_cuda(w, theta)
    LAUNCHES["mixing_aggregate"] += 1
    return out


def gram_matrix(g: torch.Tensor) -> torch.Tensor:
    """G = g gᵀ: (m, D) -> (m, m) float32."""
    if not _on_cuda(g, "gram_matrix"):
        return ref.gram_ref(g)
    out = gram_matrix_cuda(g.float().contiguous())
    LAUNCHES["gram_matrix"] += 1
    return out


def pairwise_sqdist(g: torch.Tensor) -> torch.Tensor:
    """Δ_ij = ||g_i − g_j||² via the Gram op: (m, D) -> (m, m) float32."""
    return ref.sqdist_from_gram(gram_matrix(g))


__all__ = ["LAUNCHES", "gram_matrix", "mixing_aggregate", "pairwise_sqdist",
           "ref", "reset_launches"]
