"""Resilient-runtime bookkeeping + the async retry loop.

Counterpart of `repro/fl/faults/runtime.py`.  `FaultMeter` accumulates
the per-round fault/defense counters the engine books into
``History.extra["faults"]``: crashes, quarantines, quorum-skipped
rounds, wasted uplink bits, async retries and dead clients, so a
defended run's degradation is auditable, not silent.

`pop_with_retries` is the async engines' arrival loop (pure Python over
a clock with ``__len__``, ``pop`` and ``requeue``; its caller comes with
the async runtime): a popped arrival whose crash coin fires is requeued
at ``t + backoff · 2**attempt`` without a new compute draw; a client that
crashes ``max_retries + 1`` consecutive times is dead for the run.
"""
from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np

from repro_torch.fl.faults.config import FaultPlan


class FaultMeter:
    """Run-level fault/defense counters -> ``History.extra["faults"]``."""

    def __init__(self, plan: Optional[FaultPlan], robust_spec: str,
                 min_quorum: Optional[int]):
        self.plan = plan
        self.robust_spec = robust_spec
        self.min_quorum = min_quorum
        self.crashed = 0
        self.quarantined = 0
        self.skipped = 0
        self.rounds = 0
        self.wasted_ul_bits = 0
        self.retries = 0
        self.dead: Set[int] = set()

    def charge(self, crash_row: Optional[np.ndarray],
               q_row: Optional[np.ndarray], quorum_ok: bool,
               round_ul_bits: int, quarantined_ul_bits: int = 0) -> None:
        """Book one round/event: ``crash_row`` the (m,) host crash mask
        (None = no crash axis), ``q_row`` the (m,) quarantine survival
        row (None = no defense), ``round_ul_bits`` the bits every
        participant uploaded this round (all wasted when the quorum
        fails), ``quarantined_ul_bits`` the quarantined rows' share
        (wasted even when the round lands)."""
        self.rounds += 1
        if crash_row is not None:
            self.crashed += int(np.sum(crash_row))
        if q_row is not None:
            self.quarantined += int(np.sum(q_row <= 0))
        if not quorum_ok:
            self.skipped += 1
            self.wasted_ul_bits += int(round_ul_bits)
        else:
            self.wasted_ul_bits += int(quarantined_ul_bits)

    def extra(self) -> Dict:
        cfg = None if self.plan is None else self.plan.cfg
        return {
            "faults": "none" if cfg is None else cfg.spec,
            "byzantine_clients": ([] if self.plan is None else
                                  np.flatnonzero(self.plan.byz_mask)
                                  .tolist()),
            "robust_agg": self.robust_spec,
            "min_quorum": self.min_quorum,
            "rounds": self.rounds,
            "crashed_total": self.crashed,
            "quarantined_total": self.quarantined,
            "skipped_rounds": self.skipped,
            "wasted_ul_bits": self.wasted_ul_bits,
            "retries": self.retries,
            "dead_clients": sorted(self.dead),
        }


def pop_with_retries(clock, plan: Optional[FaultPlan], max_retries: int,
                     backoff: float, attempts: Dict[int, int],
                     meter: Optional[FaultMeter] = None
                     ) -> Optional[Tuple[float, int]]:
    """Pop the next arrival that survives its crash coin.

    Crashed arrivals are requeued at ``t + backoff · 2**attempt``
    (deterministic exponential backoff, no new compute draw); a client
    whose consecutive-crash count exceeds ``max_retries`` is marked dead
    and never rescheduled.  Returns ``(t, client)``, or None once the
    heap drains (every remaining client dead) — the engines end the run
    early with a pointed warning then."""
    while len(clock):
        t, c = clock.pop()
        if plan is None or not plan.arrival_crash():
            attempts[c] = 0         # success resets the backoff ladder
            return t, c
        a = attempts.get(c, 0)
        if a >= max_retries:
            if meter is not None:
                meter.dead.add(int(c))
            continue                # cap exhausted: gone for the run
        attempts[c] = a + 1
        if meter is not None:
            meter.retries += 1
        clock.requeue(c, t + float(backoff) * (2.0 ** a))
    return None
