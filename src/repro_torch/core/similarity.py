"""Distribution-similarity statistics (paper §III-A).

Counterpart of `repro/core/similarity.py`.  The special pre-training
round: the PS broadcasts a probe model; every client computes its
full-dataset gradient ĝ_i and the Eq. 7 variance estimate σ_i² over K
contiguous mini-batch splits; the PS forms Δ_ij = ||ĝ_i − ĝ_j||², a
Gram-matrix computation over the m flat client gradients that runs
through `kernels.ops.pairwise_sqdist` (the hand-written Gram kernel on
CUDA).  Gradients come from `torch.func.grad`; ``loss_fn(params, data)``
returns a scalar.  (The round engine takes its statistics from
`fl/stats.py`; these are the reference's library API.)
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.func import grad

from repro_torch.kernels import ops


def flatten_pytree(tree) -> torch.Tensor:
    """Flat float32 vector of a param dict, leaves in sorted-key order (the
    order `jax.tree_util.tree_leaves` gives a dict)."""
    return torch.cat([tree[k].reshape(-1).float() for k in sorted(tree)])


def full_gradient(loss_fn: Callable, params, data) -> torch.Tensor:
    """ĝ_i: flat full-dataset gradient of ``loss_fn(params, data)``."""
    return flatten_pytree(grad(lambda p: loss_fn(p, data))(params))


def client_gradients(loss_fn: Callable, params,
                     datasets: Sequence) -> torch.Tensor:
    """ĝ_i of every client, stacked: (m, D)."""
    return torch.stack([full_gradient(loss_fn, params, d)
                        for d in datasets])


def delta_matrix(grads: torch.Tensor) -> torch.Tensor:
    """Δ_ij = ||g_i − g_j||² from stacked gradients (m, D), via the Gram
    matrix: ||g_i||² + ||g_j||² − 2⟨g_i, g_j⟩, clamped at ≥ 0."""
    return ops.pairwise_sqdist(grads.float().contiguous())


def _n_samples(data) -> int:
    """Leading dim of a dataset dict's first leaf in sorted-key order (the
    reference's ``tree_leaves(data)[0]``)."""
    return int(data[sorted(data)[0]].shape[0])


def sigma_estimates(loss_fn: Callable, params, datasets: Sequence, *,
                    n_batches: int = 5, key=None) -> torch.Tensor:
    """σ_i² (Eq. 7): mean squared deviation of K mini-batch gradients
    from ĝ_i.  Each dataset is a dict of tensors with a leading sample
    dim; the batches are its contiguous K-way split (bounds by Python's
    ``round``), a fixed partition as in the paper.  ``key`` is unused, as
    in the reference."""
    sigmas = []
    for data in datasets:
        n = _n_samples(data)
        g_full = full_gradient(loss_fn, params, data)
        k_splits = max(2, min(n_batches, n))
        bounds = [round(k * n / k_splits) for k in range(k_splits + 1)]
        devs = []
        for k in range(k_splits):
            sl = {name: v[bounds[k]:bounds[k + 1]]
                  for name, v in data.items()}
            g_k = full_gradient(loss_fn, params, sl)
            devs.append(torch.sum((g_k - g_full) ** 2))
        sigmas.append(torch.mean(torch.stack(devs)))
    return torch.stack(sigmas)


def similarity_round(loss_fn: Callable, probe_params, datasets: Sequence, *,
                     n_batches: int = 5
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full pre-training round: (Δ (m, m), σ² (m,), n (m,) float32)."""
    grads = client_gradients(loss_fn, probe_params, datasets)
    delta = delta_matrix(grads)
    sigma2 = sigma_estimates(loss_fn, probe_params, datasets,
                             n_batches=n_batches)
    n = torch.tensor([_n_samples(d) for d in datasets],
                     dtype=torch.float32, device=grads.device)
    return delta, sigma2, n
