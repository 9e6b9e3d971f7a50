"""The paper's contribution, in PyTorch: user-centric aggregation.

similarity  — Δ from client gradients (Gram kernel)
mixing      — Eq. 6 collaboration coefficients
streams     — k-means stream reduction
aggregation — Eq. 5 mixing of stacked param dicts (Y = W Θ kernel)
"""
from repro_torch.core.aggregation import (mix_pytree, stream_aggregate,
                                          user_centric_aggregate)
from repro_torch.core.mixing import (fedavg_weights, groupwise_weights,
                                     mixing_matrix)
from repro_torch.core.similarity import delta_matrix, flatten_pytree
from repro_torch.core.streams import StreamPlan, kmeans

__all__ = ["StreamPlan", "delta_matrix", "fedavg_weights", "flatten_pytree",
           "groupwise_weights", "kmeans", "mix_pytree", "mixing_matrix",
           "stream_aggregate", "user_centric_aggregate"]
