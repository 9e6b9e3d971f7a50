"""Hierarchy tier configuration.

Counterpart of `repro/fl/hierarchy/config.py`.  Each *user* (the
paper's flat client) owns a fleet of unequal *devices*.
`HierarchyConfig` describes the two-level round: how many devices each
user has (ragged, padded to a static ``d_max`` so the edge sub-round has
one shape), how device uploads cross the edge channel (codec and error
feedback at per-device `LinkProfile` rates), and how the user combines
them into its pseudo-update (`EdgeAggregator`, optional Bernoulli device
dropout, optional straggler dropping).

The flat configuration (one device per user, identity edge codec, mean
aggregator, zero edge latency, no edge link) is bitwise the flat
engine: `resolve_fleet_spec` then yields d_max = 1,
`partition_fleet_data` gives ``[:, None]`` views of the flat client
tensors, and the fleet update takes a shortcut that is the flat
per-user step (`repro_torch.fl.hierarchy.edge`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import numpy as np

from repro_torch.data.federated import FederatedData
from repro_torch.fl.channel import get_codec


@dataclass(frozen=True)
class HierarchyConfig:
    """Knobs of the edge-aggregation tier.

    devices_per_user:    int (uniform fleet), ``"uniform:<D>"``,
                         ``"ragged:<min>-<max>"`` (per-user counts drawn
                         from ``seed``) or an explicit per-user tuple.
                         1 = the flat-parity anchor.
    edge_aggregator:     `EdgeAggregator` spec string or instance:
                         ``mean`` (sample-weighted) or
                         ``drop_stragglers:<frac>`` (drop each user's
                         slowest ``frac`` of devices before weighting).
    edge_codec:          device→user uplink `Codec` spec or instance; the
                         identity codec skips the edge value path.
    edge_error_feedback: carry per-device EF residuals across sub-rounds
                         (the user→server channel's algebra).
    edge_link:           per-device link spec (``uniform | tiered:<f> |
                         lognormal:<s>``) resolved at m·d_max and reshaped
                         (m, d_max), or None: the backhaul is free and the
                         edge hop charges only ``edge_latency``.
    edge_latency:        fixed per-sub-round latency added to every user's
                         edge hop (units of T_dl).  0 = flat anchor.
    device_dropout:      per-(round, device) Bernoulli drop probability at
                         the edge: a dropped device's upload is lost for
                         that sub-round (its EF residual still carries the
                         tail forward).
    seed:                the ragged fleet's numpy draw only; the run's
                         draws are never touched.
    """
    devices_per_user: Union[int, str, Tuple[int, ...]] = 1
    edge_aggregator: Any = "mean"
    edge_codec: Any = "identity"
    edge_error_feedback: bool = True
    edge_link: Optional[str] = None
    edge_latency: float = 0.0
    device_dropout: float = 0.0
    seed: int = 0

    def __post_init__(self):
        from repro_torch.fl.hierarchy.edge import get_edge_aggregator
        object.__setattr__(self, "edge_codec", get_codec(self.edge_codec))
        object.__setattr__(self, "edge_aggregator",
                           get_edge_aggregator(self.edge_aggregator))
        if isinstance(self.devices_per_user, list):
            object.__setattr__(self, "devices_per_user",
                               tuple(int(d) for d in self.devices_per_user))
        # fail at construction, not inside a run
        resolve_fleet_spec(self.devices_per_user, m=2, seed=self.seed)
        if not 0.0 <= float(self.device_dropout) < 1.0:
            raise ValueError("device_dropout must be in [0, 1), got "
                             f"{self.device_dropout}")
        if float(self.edge_latency) < 0.0:
            raise ValueError("edge_latency must be >= 0, got "
                             f"{self.edge_latency}")

    def __hash__(self):
        return hash((self.devices_per_user, self.edge_aggregator.spec,
                     self.edge_codec, self.edge_error_feedback,
                     self.edge_link, self.edge_latency,
                     self.device_dropout, self.seed))


def resolve_hierarchy(hierarchy) -> Optional[HierarchyConfig]:
    """None | int | fleet spec | HierarchyConfig -> HierarchyConfig (or
    None).  An int is the ``devices_per_user`` shorthand."""
    if hierarchy is None or isinstance(hierarchy, HierarchyConfig):
        return hierarchy
    if isinstance(hierarchy, (int, str, tuple, list)):
        return HierarchyConfig(devices_per_user=hierarchy)
    raise TypeError(f"cannot resolve hierarchy from {hierarchy!r}")


def resolve_fleet_spec(spec, m: int, seed: int = 0) -> np.ndarray:
    """devices-per-user spec -> (m,) int64 device counts (all >= 1).

    ``ragged:<min>-<max>`` draws each user's count uniformly from
    [min, max] with numpy's ``default_rng(seed)``, as the reference does,
    so the counts are the reference's bit for bit."""
    if isinstance(spec, (tuple, list)):
        counts = np.asarray(spec, np.int64)
        if counts.shape != (m,):
            raise ValueError(f"devices_per_user tuple must have one entry "
                             f"per user (m={m}), got shape {counts.shape}")
    elif isinstance(spec, (int, np.integer)):
        counts = np.full(m, int(spec), np.int64)
    else:
        family, _, param = str(spec).partition(":")
        if family == "uniform":
            try:
                counts = np.full(m, int(param), np.int64)
            except ValueError:
                raise ValueError(
                    f"bad devices-per-user spec {spec!r}") from None
        elif family == "ragged":
            try:
                lo, _, hi = param.partition("-")
                lo, hi = int(lo), int(hi)
            except ValueError:
                raise ValueError(
                    f"bad devices-per-user spec {spec!r}; expected "
                    "ragged:<min>-<max>") from None
            if not 1 <= lo <= hi:
                raise ValueError("ragged devices-per-user needs "
                                 f"1 <= min <= max, got {spec!r}")
            rng = np.random.default_rng(seed)
            counts = rng.integers(lo, hi + 1, size=m).astype(np.int64)
        else:
            raise ValueError(
                f"unknown devices-per-user spec {spec!r}; one of <int> | "
                "uniform:<D> | ragged:<min>-<max> | per-user tuple")
    if np.any(counts < 1):
        raise ValueError(f"every user needs >= 1 device, got {counts}")
    return counts


def partition_fleet_data(fed: FederatedData, counts: np.ndarray,
                         d_max: int):
    """Split each user's stacked train arrays across its devices.

    Returns ``(x, y, n)`` with a nested device axis: x (m, d_max, slots,
    ...), y (m, d_max, slots), n (m, d_max), device d of user i holding
    the strided shard ``x_i[d::counts[i]]`` of the user's true samples
    (no draws).  Shards are padded to the fleet-wide slot count by cyclic
    repetition (the partitioners' own padding rule: draws are by index
    mod n, so padding is never over-sampled); invalid device slots
    (d >= counts[i]) hold zeros and n = 0, and the edge aggregator gives
    them zero weight.  The shards are numpy arrays built on the host, as
    the reference builds them; `Placement.place_fleet` moves them.

    d_max == 1 returns ``[:, None]`` views of the flat tensors: the
    flat-parity anchor partitions nothing."""
    if d_max == 1:
        return fed.x[:, None], fed.y[:, None], fed.n[:, None]
    m = fed.m
    x_np, y_np, n_np = (t.cpu().numpy() for t in (fed.x, fed.y, fed.n))
    n_int = np.maximum(n_np.astype(np.int64), 1)
    d_idx = np.arange(d_max, dtype=np.int64)[None, :]
    # device d gets ceil((n_i - d) / c_i) of user i's n_i true samples
    n_dev = np.maximum(
        (n_int[:, None] - d_idx + counts[:, None] - 1) // counts[:, None], 0)
    n_dev = np.where(d_idx < counts[:, None], n_dev, 0)
    slots = int(max(1, n_dev.max()))
    x_out = np.zeros((m, d_max, slots) + x_np.shape[2:], x_np.dtype)
    y_out = np.zeros((m, d_max, slots) + y_np.shape[2:], y_np.dtype)
    for i in range(m):
        xi, yi = x_np[i, :n_int[i]], y_np[i, :n_int[i]]
        for d in range(int(counts[i])):
            if not n_dev[i, d]:
                continue
            xs, ys = xi[d::counts[i]], yi[d::counts[i]]
            x_out[i, d] = np.resize(xs, x_out.shape[2:])
            y_out[i, d] = np.resize(ys, y_out.shape[2:])
    return x_out, y_out, n_dev.astype(n_np.dtype)
