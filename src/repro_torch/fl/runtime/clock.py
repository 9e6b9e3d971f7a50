"""Virtual clock for the async runtime.

Counterpart of `repro/fl/runtime/clock.py`, line for line: it is pure
Python and numpy, and the port keeps its own copy rather than importing
the reference package.

Event-driven simulated wall-clock over per-client upload arrivals.  Each
`schedule(client, start)` draws one client round trip from the
`SystemModel`'s shifted-exponential compute law (``t_min + Exp(1/μ)``,
units of T_dl) plus the client's uplink, and pushes the arrival onto a
heap of ``(t, client)`` tuples; `pop()` returns the earliest pending
arrival and advances `now`.  The uplink term is ρ, or with a channel's
`LinkProfile` (``link=``) and ``ul_bits`` the client's own
``payload_bits / uplink_rate``.

The parameter-server downlink is a serialized resource: `serve(duration)`
occupies it and returns the completion time, queueing behind any
broadcast still in flight; ``overlap=True`` lets an event's streams run
concurrently with an earlier event's (completion ``now + duration``), an
exact no-op in lockstep, where the downlink is always idle.

Draws come from a private ``np.random.default_rng(seed)``, one
exponential per `schedule` call whatever the channel, so the arrival
order and every time the clock returns are the reference's bit for bit,
with no replay.  Heap ties break on the client index: with ``inv_mu=0``
every draw is exactly ``t_min + ρ`` and arrivals pop in client order.
"""
from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

from repro_torch.fl.comm import SystemModel


class VirtualClock:
    """Per-client arrival heap + serialized server downlink."""

    def __init__(self, system: SystemModel, seed: int = 0, *, link=None):
        self.system = system
        self.link = link                # Optional[LinkProfile]
        self._rng = np.random.default_rng(seed)
        self._heap = []
        self.now = 0.0              # time of the latest popped arrival
        self._busy_until = 0.0      # downlink occupied through this time

    def schedule(self, client: int, start: float,
                 ul_bits: Optional[float] = None,
                 extra: float = 0.0) -> float:
        """Client downloads at ``start``; returns its sampled arrival time.

        ``ul_bits`` (with a ``link`` profile) charges the client's own
        uplink instead of the homogeneous ρ.  ``extra`` adds a
        deterministic per-client term before the compute draw (the
        reference's hierarchy tier; 0.0 is bit-exact)."""
        compute = self.system.sample_compute_time(self._rng)
        if self.link is not None and ul_bits is not None:
            uplink = self.link.uplink_time(client, ul_bits)
        else:
            uplink = self.system.rho
        t = start + extra + compute + uplink
        heapq.heappush(self._heap, (t, int(client)))
        return t

    def requeue(self, client: int, at: float) -> float:
        """Re-push an already-drawn arrival at ``at`` with NO new compute
        draw: the crash-retry path, which must not shift the clock's draw
        sequence."""
        heapq.heappush(self._heap, (float(at), int(client)))
        return float(at)

    def pop(self) -> Tuple[float, int]:
        """(arrival_time, client) of the earliest pending upload."""
        t, c = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return t, c

    def serve(self, duration: float, *, overlap: bool = False) -> float:
        """Occupy the server downlink for ``duration`` starting no earlier
        than ``now``; returns the broadcast completion time.  With
        ``overlap=True`` a transmission still in flight from an earlier
        event does not delay this one."""
        if overlap:
            done = self.now + duration
            self._busy_until = max(self._busy_until, done)
            return done
        done = max(self.now, self._busy_until) + duration
        self._busy_until = done
        return done

    def __len__(self) -> int:
        return len(self._heap)
