"""Per-client wireless link profiles.

Copied from `repro/fl/channel/link.py`, which is numpy and imports no
JAX; the port keeps its own copy (as it does `fl/comm.py`) rather than
importing the reference package.  The float semantics are the
reference's, so a clock driven through here equals the reference's bit
for bit:

  * ``dl_rate[i]`` — client i's downlink rate in bits per T_dl;
  * ``ul_ratio[i]`` — client i's uplink slowdown ρ_i (uplink moves bits
    ``ρ_i×`` slower than its downlink).

Client time is payload/rate: ``downlink_time(i, b) = b / dl_rate[i]`` and
``uplink_time(i, b) = b · ρ_i / dl_rate[i]``.  A broadcast must reach its
slowest subscriber, so a group stream is charged at ``min dl_rate`` over
the receiving cohort — an UPPER BOUND when several streams serve disjoint
subsets.  When the strategy exposes its client→stream map
(`Strategy.membership`), `round_downlink_time` charges each stream at its
OWN slowest subscriber instead — strictly tighter on heterogeneous
profiles, bit-identical on uniform ones.  Unicasts each reach one
receiver and are charged the cohort-mean per-client time.

`from_system(system, ref_bits, m)` is the exactness anchor: a uniform
profile with ``dl_rate = ref_bits`` and ``ul_ratio = ρ`` charges the
uncompressed model exactly 1.0 T_dl down and exactly ρ up — IEEE-754
guarantees ``(bits·ρ)/bits == ρ`` here — so `codec=identity` reproduces
the channel-less clock bit for bit.

Spec grammar:

  uniform                  from_system (homogeneous; parity anchor)
  tiered:<factor>          odd-indexed clients run ``factor×`` slower
  lognormal:<sigma>        per-client rates scaled by LogNormal(0, σ²)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.fl.comm import SystemModel


@dataclass(frozen=True)
class LinkProfile:
    """Per-client uplink/downlink link budget; see module docstring."""

    dl_rate: np.ndarray                 # (m,) bits per T_dl
    ul_ratio: np.ndarray                # (m,) ρ_i = uplink slowdown
    name: str = "custom"

    def __post_init__(self):
        object.__setattr__(self, "dl_rate",
                           np.asarray(self.dl_rate, np.float64))
        object.__setattr__(self, "ul_ratio",
                           np.asarray(self.ul_ratio, np.float64))
        if self.dl_rate.shape != self.ul_ratio.shape:
            raise ValueError("dl_rate and ul_ratio must have equal shape, "
                             f"got {self.dl_rate.shape} vs "
                             f"{self.ul_ratio.shape}")
        if np.any(self.dl_rate <= 0) or np.any(self.ul_ratio <= 0):
            raise ValueError("link rates/ratios must be positive")

    @property
    def m(self) -> int:
        return int(self.dl_rate.shape[0])

    def _rates(self, clients: Optional[Sequence[int]]) -> np.ndarray:
        """dl rates of a cohort; an EMPTY cohort (a sampler round with zero
        participants) falls back to the full profile — a broadcast still
        goes out to whoever listens."""
        if clients is None:
            return self.dl_rate
        idx = np.asarray(clients, np.int64)
        return self.dl_rate if idx.size == 0 else self.dl_rate[idx]

    def downlink_time(self, bits: float,
                      clients: Optional[Sequence[int]] = None) -> float:
        """One broadcast of ``bits`` to ``clients`` (None = everyone):
        charged at the slowest subscriber's rate."""
        return float(bits / np.min(self._rates(clients)))

    def uplink_time(self, client: int, bits: float) -> float:
        return float((bits * self.ul_ratio[client]) / self.dl_rate[client])

    def max_uplink_time(self, bits,
                        clients: Optional[Sequence[int]] = None) -> float:
        """Slowest participant's upload (the sync round waits for it);
        0.0 for an empty cohort — nobody uploads, nothing to wait for.
        ``bits`` may be a scalar or an (m,) per-client payload vector
        (rate-adaptive codecs); the scalar path is the vector path with a
        constant, so the two agree bit-for-bit on fixed codecs."""
        idx = (slice(None) if clients is None
               else np.asarray(clients, np.int64))
        if clients is not None and idx.size == 0:
            return 0.0
        b = bits[idx] if isinstance(bits, np.ndarray) and bits.ndim else bits
        return float(np.max((b * self.ul_ratio[idx]) / self.dl_rate[idx]))

    def mean_unicast_time(self, bits: float,
                          clients: Optional[Sequence[int]] = None) -> float:
        """Average per-unicast downlink over ``clients``: a unicast reaches
        ONE receiver at that receiver's own rate, so a batch of unicasts
        spread over the cohort is charged the cohort-mean time, not the
        slowest subscriber's (that penalty is broadcast-only)."""
        return float(np.mean(bits / self._rates(clients)))

    # ---- constructors -----------------------------------------------------

    @classmethod
    def from_system(cls, system: SystemModel, ref_bits: int,
                    m: int) -> "LinkProfile":
        """Uniform profile reproducing ``system``'s clock on a payload of
        ``ref_bits`` (the uncompressed model): 1 T_dl down, ρ up — exact."""
        return cls(dl_rate=np.full(m, float(ref_bits)),
                   ul_ratio=np.full(m, float(system.rho)),
                   name="uniform")

    @classmethod
    def tiered(cls, system: SystemModel, ref_bits: int, m: int, *,
               factor: float = 4.0) -> "LinkProfile":
        """Every other client on a ``factor×`` slower link (cell-edge
        users): deterministic, no RNG spent."""
        if factor < 1.0:
            raise ValueError(f"tiered factor must be >= 1, got {factor}")
        dl = np.full(m, float(ref_bits))
        dl[1::2] /= factor
        return cls(dl_rate=dl, ul_ratio=np.full(m, float(system.rho)),
                   name=f"tiered:{factor:g}")

    @classmethod
    def lognormal(cls, system: SystemModel, ref_bits: int, m: int, *,
                  sigma: float = 0.5, seed: int = 0) -> "LinkProfile":
        """Rates scaled by LogNormal(0, σ²) draws (shadow fading),
        median-normalized so σ spreads without shifting the typical link."""
        if sigma < 0:
            raise ValueError(f"lognormal sigma must be >= 0, got {sigma}")
        rng = np.random.default_rng(seed)
        scale = np.exp(rng.normal(0.0, sigma, size=m))
        return cls(dl_rate=float(ref_bits) * scale,
                   ul_ratio=np.full(m, float(system.rho)),
                   name=f"lognormal:{sigma:g}")


# the one list `Channel.__post_init__` validates against and
# `get_link_profile` dispatches over — extend both via this tuple
LINK_FAMILIES = ("uniform", "tiered", "lognormal")


def get_link_profile(spec, system: SystemModel, ref_bits: int,
                     m: int) -> LinkProfile:
    """``"uniform" | "tiered:<factor>" | "lognormal:<sigma>"`` ->
    LinkProfile (instances pass through)."""
    if isinstance(spec, LinkProfile):
        return spec
    family, _, param = str(spec).partition(":")
    try:
        if family == "uniform" and not param:
            return LinkProfile.from_system(system, ref_bits, m)
        if family == "tiered":
            return LinkProfile.tiered(system, ref_bits, m,
                                      **({"factor": float(param)}
                                         if param else {}))
        if family == "lognormal":
            return LinkProfile.lognormal(system, ref_bits, m,
                                         **({"sigma": float(param)}
                                            if param else {}))
    except ValueError as e:
        if "could not convert" in str(e):
            raise ValueError(f"bad link-profile parameter in {spec!r}") \
                from None
        raise
    raise ValueError(f"unknown link profile {spec!r}; families: "
                     f"{list(LINK_FAMILIES)}")


def round_downlink_time(link: LinkProfile, cost, payload_bits: int,
                        participants: Optional[Sequence[int]] = None,
                        assignment: Optional[np.ndarray] = None) -> float:
    """Total serialized downlink of one round/event — BOTH engines charge
    through here (the sync analytic clock directly, the async engine as
    its event's `serve` duration): ``n_streams`` group broadcasts plus
    ``n_unicasts`` unicasts, each moving one compressed model.
    Broadcasts are charged at the slowest participating rate (a group
    stream must reach its slowest subscriber); unicasts each reach ONE
    receiver, so they are charged the cohort-mean per-client time.  With
    a uniform `from_system` profile and the identity codec every term is
    exactly 1.0, recovering the legacy ``n_streams + n_unicasts``.

    ``assignment`` — optional (m,) client→stream map from
    `Strategy.membership` (the `StreamPlan` assignment / CFL clusters).
    When given, each broadcast is charged at ITS OWN stream's slowest
    subscriber instead of the cohort-wide minimum — strictly tighter on
    heterogeneous profiles.  The refinement only engages when some
    stream's rate actually beats the cohort minimum: whenever every
    stream bottoms out at the same rate (uniform profiles in particular)
    the legacy ``n_streams × t`` multiply is kept verbatim, so the
    identity-codec parity anchors stay bit-exact (``n·t`` and ``t`` summed
    n times differ in floating point)."""
    if assignment is not None and cost.n_streams:
        asn = np.asarray(assignment, np.int64)
        if asn.shape != (link.m,):
            raise ValueError(f"assignment must be (m,)=({link.m},), got "
                             f"{asn.shape}")
        part = (np.arange(link.m, dtype=np.int64) if participants is None
                else np.asarray(participants, np.int64))
        cohort = part if part.size else np.arange(link.m, dtype=np.int64)
        slowest = float(np.min(link.dl_rate[cohort]))
        rates = []                     # per-stream slowest subscriber rate
        for s in np.unique(asn[cohort]):
            rates.append(float(np.min(link.dl_rate[cohort[
                asn[cohort] == s]])))
        # idle streams (no subscriber in the cohort) are still charged at
        # the cohort floor: the server transmits them regardless
        rates += [slowest] * (cost.n_streams - len(rates))
        # a clamped CommCost (async buffering) can charge FEWER streams
        # than the cohort spans — membership no longer maps 1:1, keep the
        # legacy upper bound
        if len(rates) <= cost.n_streams and any(r > slowest for r in rates):
            t = float(sum(payload_bits / r for r in rates))
            if cost.n_unicasts:
                t += cost.n_unicasts * link.mean_unicast_time(
                    payload_bits, participants)
            return t
    t = cost.n_streams * link.downlink_time(payload_bits, participants)
    if cost.n_unicasts:
        t += cost.n_unicasts * link.mean_unicast_time(payload_bits,
                                                      participants)
    return t
