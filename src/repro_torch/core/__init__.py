"""The paper's contribution, in PyTorch: user-centric aggregation.

Counterpart of `repro/core/`:

similarity  — pre-training round statistics (Δ via the Gram kernel, σ², n)
mixing      — Eq. 6 collaboration coefficients
streams     — k-means stream reduction + silhouette guidance
aggregation — Eq. 5 mixing of stacked param dicts (Y = W Θ kernel)
theory      — Theorem 1 bound + bound-minimizing weights (beyond paper)
distributed — the mesh placement's collective mixing schedules over the
              ranks of a `torch.distributed` group
"""
from repro_torch.core.aggregation import (downlink_models, fedavg_aggregate,
                                          mix_pytree, stream_aggregate,
                                          user_centric_aggregate)
from repro_torch.core.distributed import MIX_SCHEDULES, mix_schedule
from repro_torch.core.mixing import (effective_samples, fedavg_weights,
                                     groupwise_weights, mixing_matrix)
from repro_torch.core.similarity import (client_gradients, delta_matrix,
                                         flatten_pytree, full_gradient,
                                         sigma_estimates, similarity_round)
from repro_torch.core.streams import (StreamPlan, kmeans, select_num_streams,
                                      silhouette_score)
from repro_torch.core.theory import bound_minimizing_weights, theorem1_bound

__all__ = [
    "downlink_models", "fedavg_aggregate", "mix_pytree", "stream_aggregate",
    "user_centric_aggregate", "effective_samples", "fedavg_weights",
    "groupwise_weights", "mixing_matrix", "client_gradients", "delta_matrix",
    "flatten_pytree",
    "full_gradient", "sigma_estimates", "similarity_round", "StreamPlan",
    "kmeans", "select_num_streams", "silhouette_score",
    "bound_minimizing_weights", "theorem1_bound", "MIX_SCHEDULES",
    "mix_schedule",
]
