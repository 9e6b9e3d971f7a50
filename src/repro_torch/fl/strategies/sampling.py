"""Client participation hooks for the round engine.

Counterpart of `repro/fl/strategies/sampling.py`.  A `ClientSampler`
decides which clients take part in a round.
The engine still runs the local update for every slot (the stacked
layout is static), then discards the work of non-participants: their
params and optimizer state are rolled back to the pre-round values, so
they hold a stale model that the server-side aggregation still sees.
The mask also limits the channel's uplink to the participants and is
exposed to strategies as `RoundContext.participation`.

The fused superstep takes every round's mask of a chunk before the
chunk runs, through `sample_traced`, which always gives a mask (all-True
where `sample` gives None) and delegates to `sample`, so the two cannot
drift.
"""
from __future__ import annotations

from typing import Any, ClassVar, Optional, Tuple

import torch


class ClientSampler:
    """``sample(rnd, m, draws)`` returns a (m,) bool CPU mask per round, or
    None for everyone."""

    # the engine's draws spend a permutation only on stochastic samplers
    # (the reference splits a sampling key off only for them)
    needs_key: ClassVar[bool] = False

    # whether `sample_traced` is implemented: the fused superstep takes a
    # chunk's masks through it (the superstep's traceability contract)
    traceable: ClassVar[bool] = False

    def sample(self, rnd: int, m: int, draws: Any) -> Optional[torch.Tensor]:
        raise NotImplementedError

    def sample_traced(self, rnd: int, m: int, draws: Any) -> torch.Tensor:
        """Sibling of `sample` for the fused superstep: ALWAYS a (m,) bool
        CPU mask (all-True where `sample` gives None; the engine's select
        with an all-True mask is a bitwise identity), from the same draws
        the eventful engine would spend."""
        raise NotImplementedError(
            f"{type(self).__name__} sets traceable=True but does not "
            "implement sample_traced")

    @property
    def cache_key(self) -> Tuple:
        """Hashable identity for the superstep cache: two samplers with
        equal keys draw the same masks from the same draws."""
        return (type(self).__name__,)


class FullParticipation(ClientSampler):
    """Every client, every round — identical to passing no sampler."""

    traceable = True

    def sample(self, rnd, m, draws):
        return None

    def sample_traced(self, rnd, m, draws):
        return torch.ones((m,), dtype=torch.bool)


class UniformFraction(ClientSampler):
    """Uniformly sample a per-round cohort without replacement: either
    ``round(fraction * m)`` clients (at least ``min_clients``) or an exact
    ``count``.  The cohort is the first k of ``draws.permutation(rnd, m)``
    (the reference's ``permutation(key, m)[:k]``)."""

    needs_key = True
    traceable = True

    def __init__(self, fraction: Optional[float] = None,
                 min_clients: int = 1, *, count: Optional[int] = None):
        if (fraction is None) == (count is None):
            raise ValueError("pass exactly one of `fraction` or `count`")
        if fraction is not None and not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        if count is not None and count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self.fraction = None if fraction is None else float(fraction)
        self.count = None if count is None else int(count)
        self.min_clients = int(min_clients)

    def cohort(self, m: int) -> int:
        """This sampler's per-round cohort size, given m."""
        if self.count is not None:
            return min(m, max(self.min_clients, self.count))
        return min(m, max(self.min_clients, int(round(self.fraction * m))))

    def sample(self, rnd, m, draws):
        k = self.cohort(m)
        if k >= m:
            return None
        idx = draws.permutation(rnd, m)[:k]
        mask = torch.zeros((m,), dtype=torch.bool)
        mask[idx.cpu()] = True
        return mask

    def sample_traced(self, rnd, m, draws):
        # delegate so the eventful and fused masks cannot drift: at full
        # cohorts (k >= m) `sample` returns None before drawing anything
        mask = self.sample(rnd, m, draws)
        return torch.ones((m,), dtype=torch.bool) if mask is None else mask

    @property
    def cache_key(self):
        return (type(self).__name__, self.fraction, self.count,
                self.min_clients)
