"""Pre-round client statistics on stacked federated data.

Counterpart of `repro/fl/stats.py`: full-dataset gradients and the Eq. 7
variance proxy at the common initialization, vectorized over clients
with `torch.func.vmap` / `grad`.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from repro_torch.core.similarity import flatten_pytree
from repro_torch.data.federated import FederatedData


def _flat_grad(loss_fn, params, x, y) -> torch.Tensor:
    g, _ = grad(loss_fn, has_aux=True)(params, {"x": x, "y": y})
    return flatten_pytree(g)


def full_client_gradients(loss_fn, params, fed: FederatedData
                          ) -> torch.Tensor:
    """ĝ_i over each client's PADDED dataset (all n_max slots, as the
    reference does); (m, D) float32."""
    return vmap(lambda x, y: _flat_grad(loss_fn, params, x, y))(fed.x,
                                                                 fed.y)


def sigma2_estimates(loss_fn, params, fed: FederatedData, k_batches: int
                     ) -> torch.Tensor:
    """Eq. 7 on contiguous slices of ``n_max // k_batches`` padded slots
    (the reference's split, not the true-n split of
    `repro.core.similarity.sigma_estimates`)."""
    bs = fed.x.shape[1] // k_batches

    def one(x_i, y_i):
        gfull = _flat_grad(loss_fn, params, x_i, y_i)
        devs = [torch.sum((_flat_grad(loss_fn, params,
                                      x_i[k * bs:(k + 1) * bs],
                                      y_i[k * bs:(k + 1) * bs])
                           - gfull) ** 2)
                for k in range(k_batches)]
        return torch.stack(devs).mean()

    return vmap(one)(fed.x, fed.y)
