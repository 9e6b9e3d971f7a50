"""Strategy protocol: the server-side aggregation surface.

Counterpart of `repro/fl/strategies/base.py`, with the async runtime's
staleness reweighting, the defense layer's quarantine reweighting and
the hierarchy tier's edge-weights hook:

    state = strategy.setup(ctx)                       # once, before round 0
    stacked, state = strategy.aggregate(state, stacked, prev, ctx)  # per round
    cost = strategy.comm(state)                       # per round, after agg

A ``traceable`` strategy also has the fused superstep's pair: the
tensors `traced_state` takes from the setup state once, and
`aggregate_traced`, the same rule as a function of them, mixing through
`TracedMix`.  Both mixing dispatchers route every weight matrix through
`quarantine_reweight` when the engine has set the defense layer's
survival row (``quarantine``), so every strategy degrades gracefully
under a defense without code of its own.  `RoundContext`'s dispatchers
also route it through `Strategy.reweight` first, which discounts stale
contributors under the async runtime (``ctx.staleness``) and is the
identity on synchronous rounds; `TracedMix` does not, since the fused
superstep is synchronous only.
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


def staleness_factors(staleness: torch.Tensor, *, schedule: str = "exp",
                      discount: float = 1.0,
                      alpha: float = 0.5) -> torch.Tensor:
    """Per-contributor staleness weights s(age) in (0, 1], float32.

    ``exp`` is FedBuff's geometric ``discount ** age``; ``poly`` is
    FedAsync's ``(1 + age) ** -alpha`` (Xie et al. 2019).  Both are
    exactly 1 at age 0.  An f32 ``pow``, as in the reference; the two
    libraries' ``pow`` may differ in the last bit."""
    age = staleness.to(torch.float32)
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=age.device)
    if schedule == "exp":
        return torch.pow(f32(discount), age)
    if schedule == "poly":
        return torch.pow(1.0 + age, f32(-alpha))
    raise ValueError(f"unknown staleness schedule {schedule!r}; "
                     "one of exp | poly")


def staleness_reweight(w: torch.Tensor, staleness: torch.Tensor,
                       discount: float, *, schedule: str = "exp",
                       alpha: float = 0.5) -> torch.Tensor:
    """Discount stale contributor columns of an aggregation-rule matrix.

    ``w`` is any (r, m) weight matrix whose columns index contributing
    client models; ``staleness[j]`` is model j's age in server versions.
    Each column is scaled by `staleness_factors` and each row rescaled
    back to its ORIGINAL mass: row-stochastic rules stay row-stochastic,
    FedFOMO's sub-stochastic rows keep their self-residual, a zero row
    stays zero.  All-zero ages are an exact identity."""
    d = staleness_factors(staleness, schedule=schedule, discount=discount,
                          alpha=alpha)
    wd = w * d[None, :].to(w.dtype)
    mass = w.sum(dim=1, keepdim=True)
    new_mass = wd.sum(dim=1, keepdim=True)
    return (wd * (mass / torch.clamp(new_mass, min=1e-12))).to(w.dtype)


def quarantine_reweight(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Zero quarantined contributor columns of an aggregation-rule matrix
    and renormalize each row back to its ORIGINAL mass.

    ``w`` is any (r, m) weight matrix whose columns index contributing
    client models; ``q[j]`` is the defense layer's survival weight of
    model j (1 kept, 0 quarantined).  Row-stochastic rules stay
    row-stochastic, UCFL's personalized rows keep their totals.  A row
    whose surviving mass is zero falls back to its undefended weights (the
    screen already zeroed the quarantined deltas, so that mixes the
    previous, finite, models).  All-ones ``q`` is an exact identity."""
    wq = w * q[None, :].to(w.dtype)
    mass = w.sum(dim=1, keepdim=True)
    new_mass = wq.sum(dim=1, keepdim=True)
    scaled = wq * (mass / torch.clamp(new_mass, min=1e-12))
    return torch.where(new_mass > 0, scaled, w).to(w.dtype)


@dataclass
class RoundContext:
    """Everything a strategy may read about the run; ``rnd``,
    ``participation`` and ``quarantine`` are set by the engine each
    round, ``staleness`` each async event."""
    fed: FederatedData
    fl: Any                         # FLConfig (kept untyped to avoid a cycle)
    loss_fn: Callable
    acc_fn: Callable
    params0: Any                    # common initialization (pre-round stats)
    seed: int
    draws: Any                      # the run's `fl.draws` object
    placement: Any                  # the run's `Placement`
    rnd: int = 0
    participation: Optional[torch.Tensor] = None   # (m,) bool, None = all
    # the async runtime: each client model's (m,) f32 age in server
    # versions (None on synchronous rounds and on events where every age
    # is 0), and the discount law `Strategy.reweight` applies to it
    staleness: Optional[torch.Tensor] = None
    staleness_discount: float = 1.0
    staleness_schedule: str = "exp"     # exp | poly
    staleness_alpha: float = 0.5        # the poly schedule's exponent
    strategy: Optional[Any] = None      # the running Strategy (`reweight`)
    # the defense layer's (m,) f32 survival row, set by the engine after
    # screening and robust aggregation (None = no defense)
    quarantine: Optional[torch.Tensor] = None

    @property
    def m(self) -> int:
        return self.fed.m

    def gather(self, tree: Any) -> Any:
        """Every client's rows of a tree of the placement's rows (a mesh
        rank's shard; the identity on `HostVmap`): what a strategy reads
        whole goes through here."""
        return self.placement.gather(tree)

    def rows(self, tree: Any) -> Any:
        """The placement's rows of an every-client (m, ...) tree."""
        return self.placement.rows(tree)

    def reweighted(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` through the strategy's `reweight` (the staleness discount;
        the identity on synchronous rounds), then with the quarantined
        columns renormalized away."""
        if self.strategy is not None:
            w = self.strategy.reweight(w, self)
        elif self.staleness is not None:    # driven without a strategy
            w = staleness_reweight(w, self.staleness,
                                   self.staleness_discount,
                                   schedule=self.staleness_schedule,
                                   alpha=self.staleness_alpha)
        if self.quarantine is not None:
            w = quarantine_reweight(w, self.quarantine)
        return w

    def mix(self, stacked: Any, w: torch.Tensor) -> Any:
        """θ_i ← Σ_j w[i,j] θ_j for a full per-client matrix (m, m)."""
        return self.placement.mix(stacked, self.reweighted(w))

    def mix_plan(self, stacked: Any, plan: Any) -> Any:
        """k-stream aggregation: centroid mix + group broadcast (staleness
        and quarantine apply to the centroid rules, before the folded
        ``centroids[assignment]`` mix)."""
        if self.staleness is not None or self.quarantine is not None:
            plan = plan._replace(centroids=self.reweighted(plan.centroids))
        return self.placement.mix_plan(stacked, plan)


class TracedMix:
    """The mixing dispatcher `Strategy.aggregate_traced` gets inside a
    fused round: `RoundContext.mix` / `mix_plan`'s arithmetic for a
    synchronous round, through the placement's `mix_traced` /
    `mix_plan_traced` hooks (no staleness: the superstep is synchronous
    only).  ``quarantine`` is the defense layer's survival row, set by
    the fused round right before `Strategy.aggregate_traced` and cleared
    right after, as `RoundContext.quarantine` is on the eventful path."""

    def __init__(self, placement: Any):
        self.placement = placement
        self.quarantine: Optional[torch.Tensor] = None

    def gather(self, tree: Any) -> Any:
        """`RoundContext.gather` inside a fused round."""
        return self.placement.gather(tree)

    def rows(self, tree: Any) -> Any:
        """`RoundContext.rows` inside a fused round."""
        return self.placement.rows(tree)

    def _reweighted(self, w: torch.Tensor) -> torch.Tensor:
        if self.quarantine is None:
            return w
        return quarantine_reweight(w, self.quarantine)

    def mix(self, stacked: Any, w: torch.Tensor) -> Any:
        """θ_i ← Σ_j w[i,j] θ_j for a full per-client matrix (m, m)."""
        return self.placement.mix_traced(stacked, self._reweighted(w))

    def mix_plan(self, stacked: Any, centroids: torch.Tensor,
                 assignment: torch.Tensor) -> Any:
        """k-stream aggregation: centroid mix + group broadcast."""
        return self.placement.mix_plan_traced(
            stacked, self._reweighted(centroids), assignment)


@dataclass
class StrategyExtras:
    """Base for typed per-strategy results attached to `History.extras`."""


@dataclass
class MixingExtras(StrategyExtras):
    """UCFL family: the Eq. 6 collaboration matrix used all run, plus the
    client→stream assignment (each client its own stream under unicast)."""
    mixing_matrix: np.ndarray
    assignment: Optional[np.ndarray] = None


@dataclass
class ClusterExtras(StrategyExtras):
    """CFL: final client -> cluster assignment."""
    clusters: np.ndarray


class Strategy(abc.ABC):
    """One server-side aggregation rule; subclass + `@register` to add."""

    name: ClassVar[str]

    # Whether `aggregate` reads its `prev` argument (the pre-update models).
    reads_prev: ClassVar[bool] = True

    # Whether `traced_state` / `aggregate_traced` are implemented and the
    # state never changes after `setup` (so `comm(state)` and
    # `membership(state)` are round-constant): the engine may then fuse
    # ``eval_every`` rounds into one superstep.
    traceable: ClassVar[bool] = False

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

    def traced_state(self, state: Any) -> Any:
        """The tensors `aggregate_traced` reads, taken once from the
        `setup` state before the first fused chunk.  Their structure must
        be a function of ``(type(self), self.spec)``: the superstep cache
        is keyed on that identity."""
        raise NotImplementedError(
            f"{type(self).__name__} sets traceable=True but does not "
            "implement traced_state")

    def aggregate_traced(self, arrays: Any, stacked: Any, prev: Any,
                         tmix: TracedMix) -> Any:
        """The fused round's sibling of `aggregate`: ``arrays`` is
        `traced_state(state)`, mixing goes through ``tmix``; returns only
        ``stacked'`` (a traceable strategy's state is round-constant).
        It must not read anything back to the host: on the card it runs
        inside a captured CUDA graph."""
        raise NotImplementedError(
            f"{type(self).__name__} sets traceable=True but does not "
            "implement aggregate_traced")

    def edge_weights(self, w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """Edge-aggregation hook of the hierarchy tier: refine the
        `EdgeAggregator`'s normalized per-device weight matrix ``w`` (m,
        d_max) given the per-device sample counts ``n`` (m, d_max).  It
        runs inside the fleet update, on the card inside a captured CUDA
        graph, so an override must be pure torch and read nothing back
        to the host.  Default: the identity; the engine threads a
        strategy's hook into the fleet update only when a subclass
        overrides it, so the default costs nothing and keeps the
        flat-parity anchor."""
        return w

    def reweight(self, w: torch.Tensor, ctx: RoundContext) -> torch.Tensor:
        """Staleness hook: `RoundContext.mix` routes every weight matrix
        through here (`mix_plan` its centroids, when the event carries
        staleness).  Default: the identity while ``ctx.staleness`` is None;
        under the async runtime, stale contributor columns discounted by
        ``ctx.staleness_schedule``, mass-preserving per row."""
        if ctx.staleness is None:
            return w
        return staleness_reweight(w, ctx.staleness, ctx.staleness_discount,
                                  schedule=ctx.staleness_schedule,
                                  alpha=ctx.staleness_alpha)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"
