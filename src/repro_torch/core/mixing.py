"""User-centric mixing coefficients (paper Eq. 6).

Counterpart of `repro/core/mixing.py` (`mixing_matrix`,
`fedavg_weights`, `groupwise_weights`, `effective_samples`):

    w_{i,j} ∝ (n_j / n_i) · exp( −Δ_{i,j} / (2 σ_i σ_j) ),   normalized over j.
"""
from __future__ import annotations

import numpy as np
import torch


def mixing_matrix(delta: torch.Tensor, sigma2: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """W (m, m), row-stochastic, from Δ (m,m), σ² (m,), dataset sizes n (m,)."""
    sigma = torch.sqrt(torch.clamp(sigma2.float(), min=1e-12))
    denom = 2.0 * sigma[:, None] * sigma[None, :]
    # log-space for stability: log w_ij = log n_j - Δ_ij / (2 σ_i σ_j) + const_i
    logits = torch.log(n.float())[None, :] - delta.float() / denom
    logits = logits - logits.max(dim=1, keepdim=True).values
    w = torch.exp(logits)
    return w / w.sum(dim=1, keepdim=True)


def fedavg_weights(n: torch.Tensor) -> torch.Tensor:
    """The FedAvg special case: every row is n / Σn."""
    w = n.float() / n.sum()
    return w[None, :].expand(n.shape[0], n.shape[0]).contiguous()


def groupwise_weights(n: torch.Tensor, group: np.ndarray
                      ) -> torch.Tensor:
    """Block-diagonal FedAvg rule: row i averages over i's group, weighted
    by dataset size (the oracle baseline).  Built on the host in numpy
    f32, as the reference builds it, then placed on ``n``'s device."""
    group = np.asarray(group)
    m = len(group)
    wmat = np.zeros((m, m), np.float32)
    nn = n.cpu().numpy()
    for g in np.unique(group):
        idx = np.where(group == g)[0]
        wmat[np.ix_(idx, idx)] = nn[idx] / nn[idx].sum()
    return torch.from_numpy(wmat).to(n.device)


def effective_samples(w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """1 / Σ_j w_ij²/n_j — the variance-reduction term of Theorem 1 per
    user."""
    return 1.0 / torch.sum(w ** 2 / torch.clamp(n[None, :], min=1.0), dim=1)
