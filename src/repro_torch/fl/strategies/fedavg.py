"""FedAvg: one global model, size-weighted average, one broadcast stream.

Counterpart of `repro/fl/strategies/fedavg.py`.
"""
from __future__ import annotations

from repro_torch.core.mixing import fedavg_weights
from repro_torch.fl.strategies.base import CommCost, RoundContext, Strategy
from repro_torch.fl.strategies.registry import register


@register
class FedAvg(Strategy):
    name = "fedavg"
    reads_prev = False

    def setup(self, ctx: RoundContext):
        return fedavg_weights(ctx.fed.n)          # (m, m), every row n/Σn

    def aggregate(self, state, stacked, prev, ctx):
        return ctx.mix(stacked, state), state

    def comm(self, state) -> CommCost:
        return CommCost(1, 0)
