"""Strategy protocol: the server-side aggregation surface.

Counterpart of `repro/fl/strategies/base.py` for synchronous rounds (the
staleness and quarantine reweighting of the async and faults engines
arrive with their slices):

    state = strategy.setup(ctx)                       # once, before round 0
    stacked, state = strategy.aggregate(state, stacked, prev, ctx)  # per round
    cost = strategy.comm(state)                       # per round, after agg
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable, ClassVar, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.federated import FederatedData


class CommCost(NamedTuple):
    """Per-round downlink accounting: broadcast streams + unicasts (time
    unit T_dl, see `repro_torch.fl.comm.SystemModel`)."""
    n_streams: int
    n_unicasts: int


@dataclass
class RoundContext:
    """Everything a strategy may read about the run; ``rnd`` is set by the
    engine each round."""
    fed: FederatedData
    fl: Any                         # FLConfig (kept untyped to avoid a cycle)
    loss_fn: Callable
    acc_fn: Callable
    params0: Any                    # common initialization (pre-round stats)
    seed: int
    draws: Any                      # the run's `fl.draws` object
    placement: Any                  # the run's `Placement`
    rnd: int = 0

    @property
    def m(self) -> int:
        return self.fed.m

    def mix(self, stacked: Any, w: torch.Tensor) -> Any:
        """θ_i ← Σ_j w[i,j] θ_j for a full per-client matrix (m, m)."""
        return self.placement.mix(stacked, w)

    def mix_plan(self, stacked: Any, plan: Any) -> Any:
        """k-stream aggregation: centroid mix + group broadcast."""
        return self.placement.mix_plan(stacked, plan)


@dataclass
class StrategyExtras:
    """Base for typed per-strategy results attached to `History.extras`."""


@dataclass
class MixingExtras(StrategyExtras):
    """UCFL family: the Eq. 6 collaboration matrix used all run, plus the
    client→stream assignment (each client its own stream under unicast)."""
    mixing_matrix: np.ndarray
    assignment: Optional[np.ndarray] = None


class Strategy(abc.ABC):
    """One server-side aggregation rule; subclass + `@register` to add."""

    name: ClassVar[str]

    # Whether `aggregate` reads its `prev` argument (the pre-update models).
    reads_prev: ClassVar[bool] = True

    @property
    def spec(self) -> str:
        """Registry spec string that reconstructs this instance."""
        return self.name

    def setup(self, ctx: RoundContext) -> Any:
        """Pre-round work (similarity stats, mixing matrices); returns the
        strategy state threaded through `aggregate`/`comm`/`extras`."""
        return None

    @abc.abstractmethod
    def aggregate(self, state: Any, stacked: Any, prev: Any,
                  ctx: RoundContext) -> Tuple[Any, Any]:
        """Server aggregation: (stacked', state')."""

    @abc.abstractmethod
    def comm(self, state: Any) -> CommCost:
        """This round's downlink cost (read after `aggregate`)."""

    def extras(self, state: Any) -> Optional[StrategyExtras]:
        """Typed end-of-run results for `History.extras`."""
        return None

    def membership(self, state: Any) -> Optional[np.ndarray]:
        """(m,) int client→stream map, or None when the strategy has none."""
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"
