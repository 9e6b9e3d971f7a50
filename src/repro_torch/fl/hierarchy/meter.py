"""Fleet resolution and edge-hop accounting.

Counterpart of `repro/fl/hierarchy/meter.py`.  `fleet_plan` resolves a
`HierarchyConfig` against one run: per-user device counts, the static
validity and straggler masks, the edge link at m·d_max reshaped (m,
d_max), the bound edge codec (rate-adaptive edge codecs pick their
per-device parameters here, as `init_channel` binds the server hop's)
and the per-user edge sub-round time.  The plan is the one resolution
point: the fleet update closes over it and the `EdgeMeter` charges from
it, so the two cannot drift.

`EdgeMeter` keeps the device→user hop's books: a `ChannelCost` a round
(every participating device uploads one edge payload and downloads the
user model once a sub-round) and the edge time on both clocks.  The sync
engines add the slowest participating user's edge time to each round
(`charge_round(edge=...)`), the async engine adds each user's own to its
arrival (`VirtualClock.schedule(extra=...)`).  With no edge link and
zero latency every charge is exactly 0.0, and ``t + 0.0`` keeps the
flat-parity anchor.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.data.federated import FederatedData
from repro_torch.fl.channel import (ChannelCost, LinkProfile,
                                    get_link_profile, tree_bits, tree_size)
from repro_torch.fl.comm import SYSTEMS, SystemModel
from repro_torch.fl.hierarchy.config import (HierarchyConfig,
                                             partition_fleet_data,
                                             resolve_fleet_spec)
from repro_torch.fl.hierarchy.edge import (EdgeState, _merge, _split,
                                           cached_fleet_update)


class FleetPlan:
    """One run's resolved hierarchy (see module docstring).  Hashable by
    (config, m, counts, keep mask, bound codec, the model's leaf shapes
    and dtypes, device): the fleet-update cache key.  The fleet update
    sizes its edge noise from the plan (``dim``), so two models of
    different widths never share a step."""

    def __init__(self, cfg: HierarchyConfig, m: int, params0: Any,
                 system: Optional[SystemModel]):
        self.cfg = cfg
        self.counts = resolve_fleet_spec(cfg.devices_per_user, m,
                                         seed=cfg.seed)
        self.m = m
        self.d_max = int(self.counts.max())
        self.valid = (np.arange(self.d_max)[None, :]
                      < self.counts[:, None])
        self.model_bits = tree_bits(params0)
        self.dim = tree_size(params0)
        self.model_spec = tuple((k, tuple(v.shape), str(v.dtype))
                                for k, v in sorted(params0.items()))
        self.device = next(iter(params0.values())).device
        sysm = SYSTEMS["wired"] if system is None else system
        n_dev = m * self.d_max
        self.link = (get_link_profile(cfg.edge_link, sysm,
                                      self.model_bits, n_dev)
                     if cfg.edge_link is not None else None)
        # rate-adaptive edge codecs bind per device (a row is a device);
        # with no edge link they bind against the uniform from_system
        # profile and collapse to their minimum spec
        bind_target = (self.link if self.link is not None
                       else LinkProfile.from_system(sysm, self.model_bits,
                                                    n_dev))
        self.codec = cfg.edge_codec.bind_link(bind_target, params0)
        self.payload_bits = int(self.codec.payload_bits(params0))
        self.pc_bits = np.asarray(
            self.codec.per_client_bits(params0, n_dev),
            np.int64).reshape(m, self.d_max)
        self.rates_dl = (self.link.dl_rate.reshape(m, self.d_max)
                         if self.link is not None else None)
        self.keep = cfg.edge_aggregator.static_keep(
            self.counts, self.valid, self.rates_dl)
        self.participating = (self.valid if self.keep is None
                              else (self.valid & self.keep))
        if self.link is not None:
            ratio = self.link.ul_ratio.reshape(m, self.d_max)
            hop = (self.payload_bits / self.rates_dl
                   + self.pc_bits * ratio / self.rates_dl)
            self.user_time = (float(cfg.edge_latency)
                              + np.where(self.participating, hop,
                                         0.0).max(axis=1))
        else:
            self.user_time = np.full(m, float(cfg.edge_latency))

    @property
    def row_local(self) -> bool:
        """Whether the fleet update is a row function of its inputs (no
        baked per-user constants): False under static straggler
        dropping, and partial async events then take the full-width
        path."""
        return self.keep is None

    @property
    def flat_exact(self) -> bool:
        """Whether the fleet update may take the bitwise flat shortcut
        (`repro_torch.fl.hierarchy.edge`); latency and link stay out of
        the condition: they are meter-only and never touch the values."""
        return (self.d_max == 1 and self.codec.is_identity
                and self.cfg.edge_aggregator.spec == "mean"
                and self.cfg.device_dropout == 0.0)

    def _key(self):
        return (self.cfg, self.m, self.counts.tobytes(),
                None if self.keep is None else self.keep.tobytes(),
                self.codec, self.model_spec, str(self.device))

    def __eq__(self, other) -> bool:
        return isinstance(other, FleetPlan) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"FleetPlan(m={self.m}, d_max={self.d_max}, "
                f"codec={self.codec.spec!r}, "
                f"agg={self.cfg.edge_aggregator.spec!r})")


def fleet_plan(cfg: HierarchyConfig, m: int, params0: Any,
               system: Optional[SystemModel]) -> FleetPlan:
    return FleetPlan(cfg, m, params0, system)


class EdgeMeter:
    """Per-round books of the device→user hop, built once a run from the
    plan (`run_federated` and `run_async` attach `extra()` as
    ``History.extra["hierarchy"]``)."""

    def __init__(self, plan: FleetPlan):
        self.plan = plan
        part = plan.participating
        self._n_dev = part.sum(axis=1).astype(np.int64)
        self._dl = self._n_dev * plan.payload_bits
        self._ul = np.where(part, plan.pc_bits, 0).sum(axis=1)
        self.user_time = plan.user_time
        self.costs: List[ChannelCost] = []

    def charge(self, mask_np: Optional[np.ndarray]) -> float:
        """One sync round's edge hop: books the participating users'
        device bits and returns the round's edge time (the slowest
        participating user's sub-round)."""
        if mask_np is None:
            idx = slice(None)
            empty = self._dl.size == 0
        else:
            idx = np.where(mask_np)[0]
            empty = idx.size == 0
        if empty:
            self.costs.append(ChannelCost(0, 0))
            return 0.0
        self.costs.append(ChannelCost(int(self._dl[idx].sum()),
                                      int(self._ul[idx].sum())))
        return float(self.user_time[idx].max())

    def charge_event(self, buffered) -> None:
        """One async event's edge hop (bits only: each arrival's edge time
        is already in its clock draw, ``schedule(extra=)``): every
        buffered user ran one edge sub-round before uploading."""
        idx = np.asarray(buffered, np.int64)
        self.costs.append(ChannelCost(int(self._dl[idx].sum()),
                                      int(self._ul[idx].sum())))

    def time_of(self, client: int) -> float:
        """The user's edge sub-round time: the async arrival's ``extra``."""
        return float(self.user_time[client])

    def extra(self) -> dict:
        plan = self.plan
        return {
            "devices_per_user": plan.counts.tolist(),
            "d_max": plan.d_max,
            "edge_codec": plan.codec.spec,
            "edge_aggregator": plan.cfg.edge_aggregator.spec,
            "edge_error_feedback": bool(plan.cfg.edge_error_feedback),
            "edge_link": (plan.link.name if plan.link is not None
                          else None),
            "edge_latency": float(plan.cfg.edge_latency),
            "device_dropout": float(plan.cfg.device_dropout),
            "edge_payload_bits": plan.payload_bits,
            "user_edge_time": plan.user_time.tolist(),
            # the device→user hop's bits a round; `History.comm_bits`
            # stays the user→server hop, so the two hops stay apart
            "comm_bits": list(self.costs),
            "edge_dl_bits_total": int(sum(c.dl_bits for c in self.costs)),
            "edge_ul_bits_total": int(sum(c.ul_bits for c in self.costs)),
        }


def init_fleet_run(cfg: HierarchyConfig, placement: Any, loss_fn: Any,
                   fl: Any, fed: FederatedData, params0: Any, *,
                   system: Optional[SystemModel], strategy: Any = None):
    """The hierarchy sibling of `init_run`'s placement block: resolves
    the plan, builds (or reuses) the fleet update, places the
    device-partitioned data and the (m, d_max, ...) `EdgeState`.  Returns
    ``(update_fn, stacked, opt_state, data, plan)``."""
    from repro_torch.fl.strategies import Strategy
    m = fed.m
    plan = fleet_plan(cfg, m, params0, system)
    edge_hook = None
    if (strategy is not None
            and type(strategy).edge_weights is not Strategy.edge_weights):
        edge_hook = strategy.edge_weights
    stacked = placement.stack(params0, m)
    # the users this placement holds (a mesh rank's shard): the step cuts
    # the plan's static straggler mask to them
    mine = placement.rows(torch.arange(m))
    opt, update_fn = cached_fleet_update(
        loss_fn, fl.local_steps, fl.batch_size, fl.lr, fl.momentum,
        getattr(fl, "opt_state_dtype", None), plan, edge_hook,
        placement.codec_backend, (int(mine[0]), int(mine[-1]) + 1))
    d_max = plan.d_max
    rows = len(mine)        # the users whose rows this placement holds
    dev0 = {k: l[:, None].expand((rows, d_max) + tuple(l.shape[1:]))
            for k, l in stacked.items()}
    dev_opt = _split(opt.init_stacked(_merge(dev0), rows * d_max), rows,
                     d_max)
    edge_ef = (None if plan.codec.is_identity else
               {k: torch.zeros(l.shape, dtype=torch.float32,
                               device=l.device) for k, l in dev0.items()})
    data = placement.place_fleet(
        partition_fleet_data(fed, plan.counts, d_max), m, plan.device)
    return update_fn, stacked, EdgeState(dev_opt, edge_ef), data, plan
