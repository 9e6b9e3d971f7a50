"""Communication/straggler time model (paper §IV-C).

Copied from `repro/fl/comm.py` (`harmonic`, `SystemModel` with the async
runtime's compute draws, `SYSTEMS`, `downlink_cost`); it is pure Python,
and the port keeps its own copy rather than importing the reference
package.

Time unit = T_dl (one model broadcast on the downlink).
  * uplink per round: ρ = T_ul/T_dl ∈ [1, 4]   (clients upload in parallel)
  * downlink per round: one T_dl per distinct model stream (group broadcast);
    client-side personalization (FedFOMO) needs unicasts — one per
    (client, candidate model) pair.
  * compute: shifted exponential per client; the round waits for the slowest:
    E[max] = T_min + H_m/μ (H_m the m-th harmonic number).

The per-algorithm downlink table lives on each Strategy class
(`Strategy.downlink_cost`); `downlink_cost` here is the string entry
point and resolves the spec through the registry.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

_EULER_GAMMA = 0.5772156649015329
_HARMONIC_EXACT_MAX = 64


def harmonic(m: int) -> float:
    """H_m = Σ_{i<=m} 1/i.  Exact sum up to ``_HARMONIC_EXACT_MAX``; above
    it the asymptotic expansion ln(m) + γ + 1/(2m) − 1/(12m²)."""
    m = int(m)
    if m <= 0:
        return 0.0
    if m <= _HARMONIC_EXACT_MAX:
        return sum(1.0 / i for i in range(1, m + 1))
    return math.log(m) + _EULER_GAMMA + 1.0 / (2 * m) - 1.0 / (12 * m * m)


@dataclass(frozen=True)
class SystemModel:
    rho: float = 4.0            # T_ul / T_dl
    t_min: float = 1.0          # min compute time, units of T_dl
    inv_mu: float = 1.0         # 1/μ: mean extra straggler delay (0 = reliable)
    name: str = "wireless-slow-ul"

    def compute_time(self, m: int) -> float:
        return self.t_min + self.inv_mu * harmonic(m) if self.inv_mu else self.t_min

    def round_time(self, m: int, *, n_streams: int = 1,
                   n_unicasts: int = 0) -> float:
        """Analytic synchronous round: E[max of m stragglers] + UL + DL,
        ``m`` the participant count."""
        return self.compute_time(m) + self.rho + n_streams + n_unicasts

    def sample_compute_time(self, rng) -> float:
        """One client's compute draw for the async runtime: the shifted
        exponential ``t_min + Exp(1/μ)`` whose order statistics give the
        analytic ``E[max] = t_min + H_m/μ``.  ``inv_mu=0`` is the
        deterministic ``t_min`` (lockstep arrivals).  Exactly one draw
        from the numpy Generator ``rng`` when ``inv_mu > 0``, none
        otherwise: the virtual clock's draw sequence depends on that."""
        extra = float(rng.exponential(self.inv_mu)) if self.inv_mu else 0.0
        return self.t_min + extra

    def sample_client_time(self, rng) -> float:
        """Compute draw plus the homogeneous ρ uplink: the whole
        download-to-upload round trip under this system's own channel
        (a `LinkProfile` replaces the ρ term per client)."""
        return self.sample_compute_time(rng) + self.rho


# the three systems of Fig. 3
WIRELESS_SLOW_UL = SystemModel(rho=4.0, t_min=1.0, inv_mu=1.0,
                               name="wireless rho=4, unreliable")
WIRELESS_FAST_UL = SystemModel(rho=2.0, t_min=1.0, inv_mu=0.0,
                               name="wireless rho=2, reliable")
WIRED = SystemModel(rho=1.0, t_min=1.0, inv_mu=0.0, name="wired rho=1")

SYSTEMS = {"wireless_slow": WIRELESS_SLOW_UL,
           "wireless_fast": WIRELESS_FAST_UL,
           "wired": WIRED}


def downlink_cost(algorithm: str, m: int, n_streams: int = 1,
                  fomo_candidates: int = 5):
    """(n_streams, n_unicasts) per round, a shim over the registry: each
    Strategy class owns its entry (``Strategy.downlink_cost``).  An
    unknown spec raises ValueError."""
    from repro_torch.fl.strategies import get_strategy_class
    cls = get_strategy_class(algorithm)
    return tuple(cls.downlink_cost(m, n_streams=n_streams,
                                   fomo_candidates=fomo_candidates))
