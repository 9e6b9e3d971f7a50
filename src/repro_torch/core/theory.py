"""Theorem 1 machinery: the excess-risk bound and a bound-minimising
weight rule (a beyond-paper alternative to the Eq. 6 heuristic).

Counterpart of `repro/core/theory.py`:

    gap(i) <= B·sqrt(Σ_j w_ij²/n_j)·( sqrt(2d/N·log(eN/d)) + sqrt(log(2/δ)) )
              + 2·Σ_j w_ij·d_F(P_i,P_j) + 2λ

The discrepancy d_F is unobservable under FL constraints; the paper's
heuristic substitutes the gradient score.  `bound_minimizing_weights`
instead descends the bound over row-stochastic W (softmax logits, plain
gradient steps through `torch.func.grad`), in float32 as the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.func import grad


def estimation_term(w: torch.Tensor, n: torch.Tensor, *, B: float = 1.0,
                    d_vc: float = 100.0, delta: float = 0.05) -> torch.Tensor:
    """First bound term, per user (vectorised over rows of w)."""
    big_n = torch.sum(n)
    cplx = (torch.sqrt(2 * d_vc / big_n * torch.log(math.e * big_n / d_vc))
            + torch.sqrt(torch.log(torch.tensor(2.0 / delta,
                                                dtype=torch.float32,
                                                device=n.device))))
    return B * torch.sqrt(torch.sum(
        w ** 2 / torch.clamp(n[None, :], min=1.0), dim=1)) * cplx


def bias_term(w: torch.Tensor, disc: torch.Tensor) -> torch.Tensor:
    """2 Σ_j w_ij d_F(P_i, P_j) per user; disc: (m, m) discrepancy proxy."""
    return 2.0 * torch.sum(w * disc, dim=1)


def theorem1_bound(w: torch.Tensor, n: torch.Tensor, disc: torch.Tensor, *,
                   B: float = 1.0, d_vc: float = 100.0, delta: float = 0.05,
                   lam: float = 0.0) -> torch.Tensor:
    """Per-user upper bound on the excess risk of the personalised model."""
    return (estimation_term(w, n, B=B, d_vc=d_vc, delta=delta)
            + bias_term(w, disc) + 2.0 * lam)


def bound_minimizing_weights(n: torch.Tensor, disc: torch.Tensor, *,
                             B: float = 1.0, d_vc: float = 100.0,
                             delta: float = 0.05, steps: int = 500,
                             lr: float = 0.5
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimise Theorem 1's bound over row-stochastic W: ``steps``
    gradient steps on softmax logits from zeros.  Returns (W*, the
    per-user bound at W*)."""
    m = n.shape[0]
    n, disc = n.float(), disc.float()

    def obj(logits):
        w = torch.softmax(logits, dim=1)
        return torch.sum(theorem1_bound(w, n, disc, B=B, d_vc=d_vc,
                                        delta=delta))

    grad_fn = grad(obj)
    logits = torch.zeros((m, m), dtype=torch.float32, device=n.device)
    for _ in range(steps):
        logits = logits - lr * grad_fn(logits)
    w = torch.softmax(logits, dim=1)
    return w, theorem1_bound(w, n, disc, B=B, d_vc=d_vc, delta=delta)
