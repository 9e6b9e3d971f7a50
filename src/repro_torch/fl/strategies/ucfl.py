"""User-centric FL (the paper's method).

Counterpart of `repro/fl/strategies/ucfl.py`.  `UCFL()` is full
personalization: one similarity round at the common initialization
builds the Eq. 6 mixing matrix W (Δ through the Gram kernel), and every
round each client receives its own W-row mixture (m unicast streams).
`UCFL(k=...)` (spec ``ucfl_k<k>``) is the §III-B stream reduction: k-means
over the rows of W yields k centroid rules served by group broadcast.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import kmeans, mixing_matrix
from repro_torch.core.similarity import delta_matrix
from repro_torch.core.streams import StreamPlan
from repro_torch.fl.stats import full_client_gradients, sigma2_estimates
from repro_torch.fl.strategies.base import (CommCost, MixingExtras,
                                            RoundContext, Strategy)
from repro_torch.fl.strategies.registry import register


class UCFLState(NamedTuple):
    w: torch.Tensor                 # (m, m) Eq. 6 mixing matrix
    plan: Optional[StreamPlan]      # k-means stream plan (None = unicast)
    n_streams: int


@register
class UCFL(Strategy):
    name = "ucfl"
    reads_prev = False
    traceable = True        # pure W / StreamPlan mix, round-constant state

    def __init__(self, k: Optional[int] = None):
        if k is not None and k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k

    @property
    def spec(self) -> str:
        return self.name if self.k is None else f"{self.name}_k{self.k}"

    def setup(self, ctx: RoundContext) -> UCFLState:
        grads = full_client_gradients(ctx.loss_fn, ctx.params0, ctx.fed)
        delta = delta_matrix(grads)
        sigma2 = sigma2_estimates(ctx.loss_fn, ctx.params0, ctx.fed,
                                  ctx.fl.sigma_batches)
        w = mixing_matrix(delta, sigma2, ctx.fed.n)
        if self.k is None:
            return UCFLState(w=w, plan=None, n_streams=ctx.fed.m)
        plan = kmeans(w, self.k, first=ctx.draws.kmeans_first(ctx.fed.m))
        # kmeans clamps k to m: report the streams actually transmitted
        return UCFLState(w=w, plan=plan,
                         n_streams=int(plan.centroids.shape[0]))

    def aggregate(self, state: UCFLState, stacked, prev, ctx):
        if state.plan is None:
            return ctx.mix(stacked, state.w), state
        return ctx.mix_plan(stacked, state.plan), state

    def traced_state(self, state: UCFLState):
        # structure depends only on the spec: unicast (k=None) mixes the
        # full W, stream reduction mixes the k-means plan
        if state.plan is None:
            return (state.w,)
        return (state.plan.centroids, state.plan.assignment)

    def aggregate_traced(self, arrays, stacked, prev, tmix):
        if len(arrays) == 1:
            return tmix.mix(stacked, arrays[0])
        return tmix.mix_plan(stacked, arrays[0], arrays[1])

    def comm(self, state: UCFLState) -> CommCost:
        return CommCost(state.n_streams, 0)

    def membership(self, state: UCFLState) -> np.ndarray:
        if state.plan is None:          # full personalization: own stream
            return np.arange(state.w.shape[0], dtype=np.int64)
        return state.plan.assignment.cpu().numpy().astype(np.int64)

    def extras(self, state: UCFLState) -> MixingExtras:
        return MixingExtras(mixing_matrix=state.w.cpu().numpy(),
                            assignment=self.membership(state))
