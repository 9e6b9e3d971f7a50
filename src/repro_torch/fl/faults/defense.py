"""Screening + robust aggregation.

Counterpart of `repro/fl/faults/defense.py`.  The defense layer runs
between the codec uplink and the strategy's aggregation, on the
server-side decoded updates, before any mixing:

    screen:  non-finite rows are quarantined (q=0) and their deltas
             zeroed, so 0·NaN can never poison a personalized stream;
    robust:  the selected `RobustAggregator` transforms the surviving
             (m, D) flat deltas: clip | trimmed_mean | median | krum.

The returned quarantine weights ``q`` (1 kept, 0 quarantined) go through
`quarantine_reweight` inside `RoundContext.mix` / `TracedMix`, so every
registered strategy renormalizes the surviving mass per row.
``get_robust_aggregator("none")`` (and None) resolve to None: no screen,
no transform, the undefended engine.

Every transform is torch on the device with no read back to the host,
so it runs inside a fused round (a captured CUDA graph on the card).
The order statistics (trimmed_mean, median) sort each column once and
pick the reference's ranks (`jnp.nanquantile`'s ``q · (count − 1)``,
its "lower", "higher" and "midpoint" rules), which gives its values
bitwise and has no size cap.  Krum sums the squared differences over the
(m, m, D) broadcast, as the reference does.  Under partial participation
non-transmitting rows enter with Δ = 0 and the order statistics treat
those zeros as data, as the reference's do.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.fl.channel.payload import stacked_ravel, stacked_unravel

ROBUST_AGGS: Dict[str, Callable[..., "RobustAggregator"]] = {}


def register_robust(name: str):
    def deco(cls):
        cls.name = name
        ROBUST_AGGS[name] = cls
        return cls
    return deco


class RobustAggregator(abc.ABC):
    """One robust transform on the (m, D) flat client deltas."""

    name: str

    @property
    def spec(self) -> str:
        return self.name

    @abc.abstractmethod
    def transform(self, delta: torch.Tensor, keep: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(delta', keep'): ``delta`` is the screened (m, D) update stack
        (quarantined rows already zeroed), ``keep`` the (m,) float32
        survival weights.  Selection rules (krum) zero more of ``keep``;
        value rules (clip/trim/median) reshape ``delta``."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


def _nan_where(delta: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Quarantined rows as NaN, so the nan-aware order statistics skip
    them instead of counting their zeroed deltas."""
    return torch.where(keep[:, None] > 0, delta,
                       torch.full((), float("nan"), device=delta.device))


class _Columns:
    """The columns of an (m, D) view sorted once (NaN last) with their
    counts of non-NaN entries, for the order statistics."""

    def __init__(self, x: torch.Tensor):
        self.srt = torch.sort(x, dim=0).values
        self.count = (~torch.isnan(self.srt)).sum(dim=0, keepdim=True).to(
            x.dtype)

    def at(self, q: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(D,) ``(lower, higher)`` order statistics at quantile ``q``, as
        `jnp.nanquantile` picks them: rank ``f32(q) · (count − 1)``,
        floored and ceiled, clamped into [0, count − 1]; NaN where a
        column has no entry."""
        rank = (self.count - 1.0) * q           # f32(q) · (count − 1)
        top = self.count - 1.0
        zero = torch.zeros((), dtype=rank.dtype, device=rank.device)

        def pick(r):
            r = torch.maximum(zero, torch.minimum(r, top))
            return self.srt.gather(0, r.to(torch.int64))[0]

        return pick(torch.floor(rank)), pick(torch.ceil(rank))


@register_robust("clip")
class Clip(RobustAggregator):
    """Per-row L2 norm clip at a static bound ``c``: the cheapest screen
    against magnitude attacks; direction attacks (sign flip) pass."""

    def __init__(self, c: float = 1.0):
        if c <= 0:
            raise ValueError(f"clip bound must be > 0, got {c}")
        self.c = float(c)

    @property
    def spec(self) -> str:
        return f"clip:{self.c:g}"

    def transform(self, delta, keep):
        norm = torch.linalg.vector_norm(delta, dim=1, keepdim=True)
        scale = torch.minimum(torch.ones((), device=delta.device),
                              self.c / torch.clamp(norm, min=1e-12))
        return delta * scale, keep


@register_robust("trimmed_mean")
class TrimmedMean(RobustAggregator):
    """Coordinate-wise winsorization at the (f, 1−f) quantiles of the
    surviving rows: every entry is clamped into the robust interval, so
    any downstream weighted mean is a winsorized (trimmed-family) mean,
    the form that composes with per-client mixing matrices."""

    def __init__(self, f: float = 0.1):
        if not 0.0 < f < 0.5:
            raise ValueError("trimmed_mean fraction must be in (0, 0.5), "
                             f"got {f}")
        self.f = float(f)

    @property
    def spec(self) -> str:
        return f"trimmed_mean:{self.f:g}"

    def transform(self, delta, keep):
        cols = _Columns(_nan_where(delta, keep))
        # inner order statistics ("higher" of f, "lower" of 1 − f), not
        # interpolated: interpolation would blend a fraction of an extreme
        # (possibly adversarial, possibly huge) value into the bound
        lo = cols.at(self.f)[1]
        hi = cols.at(1.0 - self.f)[0]
        clamped = torch.minimum(torch.maximum(delta, lo), hi)
        # all rows quarantined -> NaN bounds: keep the (zeroed) deltas
        return torch.where(torch.isnan(lo)[None, :], delta, clamped), keep


@register_robust("median")
class Median(RobustAggregator):
    """Coordinate-wise median of the surviving rows, broadcast to every
    row: the strongest value defense (breakdown 1/2) but personalization-
    free — all clients receive the same robust delta."""

    @property
    def spec(self) -> str:
        return "median"

    def transform(self, delta, keep):
        lower, higher = _Columns(_nan_where(delta, keep)).at(0.5)
        med = (lower + higher) * 0.5            # jnp.nanmedian's midpoint
        med = torch.where(torch.isnan(med), torch.zeros_like(med), med)
        return med[None, :].expand(delta.shape), keep


@register_robust("krum")
class Krum(RobustAggregator):
    """Multi-Krum selection (Blanchard et al. 2017): score each client by
    the sum of its m−f−2 smallest squared distances to the others and
    quarantine the f highest-scoring clients (``f = round(frac·m)``
    assumed adversaries).  A pure selection rule: ``delta`` is untouched,
    ``keep`` shrinks."""

    def __init__(self, frac: float = 0.25):
        if not 0.0 < frac < 0.5:
            raise ValueError("krum byzantine fraction must be in (0, 0.5), "
                             f"got {frac}")
        self.frac = float(frac)

    @property
    def spec(self) -> str:
        return f"krum:{self.frac:g}"

    def transform(self, delta, keep):
        m = delta.shape[0]
        f = int(round(self.frac * m))
        if m - f - 2 < 1:       # cohort too small to score: keep everyone
            return delta, keep
        diff = delta[:, None, :] - delta[None, :, :]
        sq = (diff * diff).sum(dim=-1)
        inf = torch.full((), float("inf"), device=delta.device)
        drop = keep <= 0
        eye = torch.eye(m, dtype=torch.bool, device=delta.device)
        sq = torch.where(eye | drop[None, :] | drop[:, None], inf, sq)
        nearest = torch.sort(sq, dim=1).values[:, :m - f - 2]
        score = torch.where(drop, inf, nearest.sum(dim=1))
        # keep the m−f lowest-scoring clients (among survivors)
        cut = torch.sort(score).values[m - f - 1]
        selected = (score <= cut) & ~drop
        return delta, keep * selected.to(keep.dtype)


def get_robust_aggregator(spec: Union[str, RobustAggregator, None]
                          ) -> Optional[RobustAggregator]:
    """``none | clip:<c> | trimmed_mean:<f> | median | krum:<f>`` ->
    `RobustAggregator` (None = no defense)."""
    if spec is None or isinstance(spec, RobustAggregator):
        return spec
    family, _, param = str(spec).partition(":")
    if family == "none":
        if param:
            raise ValueError(f"robust aggregator 'none' takes no parameter, "
                             f"got {spec!r}")
        return None
    cls = ROBUST_AGGS.get(family)
    if cls is None:
        raise ValueError(f"unknown robust aggregator {spec!r}; one of "
                         f"none | {' | '.join(sorted(ROBUST_AGGS))}")
    try:
        return cls(float(param)) if param else cls()
    except TypeError:
        raise ValueError(f"robust aggregator {family!r} takes no parameter, "
                         f"got {spec!r}") from None


def screen_and_defend(agg: RobustAggregator, stacked: Any, prev: Any,
                      placement: Optional[Any] = None
                      ) -> Tuple[Any, torch.Tensor]:
    """The full defense pipeline on the server-side decoded stack:
    non-finite screen -> robust transform.  Returns ``(stacked',
    quarantine)``, ``quarantine`` the (m,) float32 survival row (1 kept,
    0 quarantined) for `quarantine_reweight`.  With a ``placement`` the
    stacks are its rows: the (m, D) deltas are gathered first (the
    robust rules read every client), and its rows of ``stacked'`` come
    back."""
    if placement is not None:
        stacked, prev = placement.gather((stacked, prev))
    flat_prev = stacked_ravel(prev)
    delta = stacked_ravel(stacked) - flat_prev
    finite = torch.isfinite(delta).all(dim=1)
    keep = finite.to(torch.float32)
    delta = torch.where(finite[:, None], delta, torch.zeros_like(delta))
    delta, keep = agg.transform(delta, keep)
    out = stacked_unravel(flat_prev + delta, stacked)
    return (out if placement is None else placement.rows(out)), keep
