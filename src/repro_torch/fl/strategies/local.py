"""Local-only baseline: no aggregation, no downlink.

Counterpart of `repro/fl/strategies/local.py`.
"""
from __future__ import annotations

from repro_torch.fl.strategies.base import CommCost, Strategy
from repro_torch.fl.strategies.registry import register


@register
class Local(Strategy):
    name = "local"
    reads_prev = False
    traceable = True        # identity aggregation: trivially fusible

    def aggregate(self, state, stacked, prev, ctx):
        return stacked, state

    def traced_state(self, state):
        return None

    def aggregate_traced(self, arrays, stacked, prev, tmix):
        return stacked

    def comm(self, state) -> CommCost:
        return CommCost(0, 0)
