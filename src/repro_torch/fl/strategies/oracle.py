"""Oracle baseline: FedAvg within the ground-truth clusters.

Counterpart of `repro/fl/strategies/oracle.py`: the block-diagonal
group-FedAvg rule of `core.mixing.groupwise_weights`, mixed every round
(Y = W Θ on the card), one broadcast stream per true group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.mixing import groupwise_weights
from repro_torch.fl.strategies.base import CommCost, RoundContext, Strategy
from repro_torch.fl.strategies.registry import register


class OracleState(NamedTuple):
    weights: torch.Tensor   # (m, m) block-diagonal group-FedAvg rule
    n_streams: int          # one broadcast per true group


@register
class Oracle(Strategy):
    name = "oracle"
    reads_prev = False
    traceable = True        # pure block-diagonal W-mix

    def setup(self, ctx: RoundContext) -> OracleState:
        group = ctx.fed.group.cpu().numpy()
        return OracleState(weights=groupwise_weights(ctx.fed.n, group),
                           n_streams=int(group.max()) + 1)

    def aggregate(self, state: OracleState, stacked, prev, ctx):
        return ctx.mix(stacked, state.weights), state

    def traced_state(self, state: OracleState):
        return state.weights

    def aggregate_traced(self, arrays, stacked, prev, tmix):
        return tmix.mix(stacked, arrays)

    def comm(self, state: OracleState) -> CommCost:
        return CommCost(state.n_streams, 0)
