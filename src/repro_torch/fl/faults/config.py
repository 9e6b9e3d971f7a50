"""Fault-injection configuration.

Counterpart of `repro/fl/faults/config.py`.  `FaultConfig` describes WHAT
goes wrong (per-round client crash probability, non-finite uploads,
scaled/sign-flipped Byzantine updates, update bit-rot) and `FaultPlan`
is its once-per-run resolution at a known population size: the static
Byzantine client set is drawn here from a private numpy Generator, as in
the reference, so the same seed gives the same adversaries as the
reference's run, bit for bit and without replay, and the run's draws
object is never touched.

The whole subsystem is off by default: ``resolve_fault_plan(None, m)``
and an all-zero-rate config both resolve to ``None``, and the engine's
``plan is None`` path is the faults-off engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

_BYZ_MODES = ("sign_flip", "scale")


@dataclass(frozen=True)
class FaultConfig:
    """Knobs of the per-round fault injector.

    crash:          per-round probability each client crashes (no-show:
                    its update never reaches the server; sync engines
                    roll the row back, the async runtime retries the
                    arrival with exponential backoff).
    nan:            per-round probability a client uploads a non-finite
                    (NaN) update.
    byz:            fraction of the population that is Byzantine — a
                    STATIC client set drawn once per run from ``seed``
                    (``round(byz * m)`` clients), not a per-round coin.
    byz_mode:       what Byzantine clients transmit: ``sign_flip``
                    (−byz_scale · Δ, gradient-ascent attack) or ``scale``
                    (+byz_scale · Δ, magnitude attack).
    byz_scale:      magnitude multiplier of either mode.
    bitrot:         per-round probability a client's upload suffers
                    memory bit-rot; affected rows get one random IEEE-754
                    bit flipped in a ``bitrot_density`` fraction of their
                    update entries.
    bitrot_density: per-entry flip probability within a bit-rotted row.
    seed:           Byzantine-set draw + the async arrival-crash stream;
                    independent of the run's draws object.
    """
    crash: float = 0.0
    nan: float = 0.0
    byz: float = 0.0
    byz_mode: str = "sign_flip"
    byz_scale: float = 10.0
    bitrot: float = 0.0
    bitrot_density: float = 1e-4
    seed: int = 0

    def __post_init__(self):
        for name in ("crash", "nan", "byz", "bitrot"):
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"faults: {name} must be a probability in "
                                 f"[0, 1], got {v}")
        if self.byz_mode not in _BYZ_MODES:
            raise ValueError(f"faults: unknown byz mode {self.byz_mode!r}; "
                             f"one of {' | '.join(_BYZ_MODES)}")
        if float(self.byz_scale) <= 0.0:
            raise ValueError("faults: byz_scale must be > 0, got "
                             f"{self.byz_scale}")
        if not 0.0 < float(self.bitrot_density) <= 1.0:
            raise ValueError("faults: bitrot_density must be in (0, 1], got "
                             f"{self.bitrot_density}")

    @property
    def active(self) -> bool:
        """Whether any fault can ever fire — all-zero rates are the
        faults-off parity path (`resolve_fault_plan` returns None)."""
        return (self.crash > 0 or self.nan > 0 or self.byz > 0
                or self.bitrot > 0)

    @property
    def spec(self) -> str:
        """Spec string that reparses to this config (History bookkeeping
        + checkpoint meta)."""
        parts = []
        if self.crash > 0:
            parts.append(f"crash:{self.crash:g}")
        if self.nan > 0:
            parts.append(f"nan:{self.nan:g}")
        if self.byz > 0:
            parts.append(f"byz:{self.byz:g}:{self.byz_mode}"
                         f":{self.byz_scale:g}")
        if self.bitrot > 0:
            parts.append(f"bitrot:{self.bitrot:g}:{self.bitrot_density:g}")
        if self.seed:
            parts.append(f"seed:{self.seed}")
        return ",".join(parts) if parts else "none"


def parse_fault_spec(spec: str) -> FaultConfig:
    """``crash:<p>,nan:<p>,byz:<f>[:<mode>[:<scale>]],bitrot:<p>[:<d>],
    seed:<s>`` -> `FaultConfig` (the ``--faults`` CLI grammar)."""
    kw = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part or part == "none":
            continue
        kind, _, rest = part.partition(":")
        args = rest.split(":") if rest else []
        try:
            if kind in ("crash", "nan", "bitrot") and 1 <= len(args) <= (
                    2 if kind == "bitrot" else 1):
                kw[kind] = float(args[0])
                if kind == "bitrot" and len(args) == 2:
                    kw["bitrot_density"] = float(args[1])
            elif kind == "byz" and 1 <= len(args) <= 3:
                kw["byz"] = float(args[0])
                if len(args) >= 2:
                    kw["byz_mode"] = args[1]
                if len(args) == 3:
                    kw["byz_scale"] = float(args[2])
            elif kind == "seed" and len(args) == 1:
                kw["seed"] = int(args[0])
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad fault spec entry {part!r}; entries are "
                "crash:<p> | nan:<p> | byz:<frac>[:<mode>[:<scale>]] | "
                "bitrot:<p>[:<density>] | seed:<int>") from None
    return FaultConfig(**kw)


class FaultPlan:
    """A `FaultConfig` resolved at population size ``m`` (once, at the
    start of a run): the static Byzantine client set plus the async
    runtime's private arrival-crash stream."""

    def __init__(self, cfg: FaultConfig, m: int):
        self.cfg = cfg
        self.m = int(m)
        rng = np.random.default_rng(cfg.seed)
        n_byz = int(round(float(cfg.byz) * self.m))
        byz = np.zeros(self.m, dtype=bool)
        if n_byz:
            byz[rng.permutation(self.m)[:n_byz]] = True
        self.byz_mask = byz
        # arrival-level crash decisions (the async runtime):
        # one uniform draw per popped arrival, deterministic in the seed
        # and independent of both the clock's and the engines' streams
        self._rng = np.random.default_rng(np.random.SeedSequence(
            [int(cfg.seed), 0x5FA17]))

    @property
    def value_faults(self) -> bool:
        """Whether the traced value-fault transform does anything (the
        crash axis is handled by row rollback / arrival retry instead)."""
        return (self.cfg.nan > 0 or self.cfg.bitrot > 0
                or bool(self.byz_mask.any()))

    def byz_row(self, idx: Optional[np.ndarray] = None) -> np.ndarray:
        """(m,) — or cohort-gathered (k,) — float32 Byzantine indicator
        row, threaded through the fused round's ``consts`` (a static
        buffer of the captured graph, not a constant baked into it)."""
        mask = self.byz_mask if idx is None else self.byz_mask[idx]
        return mask.astype(np.float32)

    def arrival_crash(self) -> bool:
        """The async runtime's crash coin for one popped arrival."""
        return bool(self._rng.random() < self.cfg.crash)

    def __repr__(self) -> str:
        return (f"FaultPlan({self.cfg.spec!r}, m={self.m}, "
                f"byzantine={np.flatnonzero(self.byz_mask).tolist()})")


def resolve_faults(faults: Union[str, FaultConfig, None]
                   ) -> Optional[FaultConfig]:
    """None | spec string | FaultConfig -> FaultConfig (or None).  An
    all-zero-rate config normalizes to None — the parity path."""
    if faults is None:
        return None
    if isinstance(faults, str):
        faults = parse_fault_spec(faults)
    if not isinstance(faults, FaultConfig):
        raise TypeError(f"cannot resolve faults from {faults!r}")
    return faults if faults.active else None


def resolve_fault_plan(faults: Union[str, FaultConfig, None],
                       m: int) -> Optional[FaultPlan]:
    """The engines' entry point: spec-ish -> `FaultPlan` at population m
    (None whenever no fault can ever fire)."""
    cfg = resolve_faults(faults)
    return None if cfg is None else FaultPlan(cfg, m)
