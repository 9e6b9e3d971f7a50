"""Edge sub-round: per-device local updates and edge aggregation.

Counterpart of `repro/fl/hierarchy/edge.py`.  `FleetUpdate` (built by
`build_fleet_update`, as in the reference) makes the whole edge
sub-round of one user fleet into a drop-in replacement for the engine's
per-user update step (`placement.host.ClientUpdate`),

    fleet_update(stacked, est, x, y, n, fd) -> (stacked', est')

with the device axis nested inside: params and optimizer state
broadcast to (m, d_max, ...), the client update run over the m·d_max
device rows, the device→user uplink through the edge codec with
per-device error feedback, and the `EdgeAggregator`'s weighted combine
back to the (m, ...) user stack.  The engines never learn about
devices: `EdgeState` rides in the optimizer-state slot, which they treat
as opaque, so sampler rollback, the fused chunk's carry and the async
cohort's gather all apply unchanged.

Flat parity: with one device per user, the identity edge codec, the mean
aggregator and no dropout, the edge tier is the identity, and it runs as
the identity (a shortcut running the flat per-user step on squeezed
views), because ``prev + 1.0·(new − prev)`` is not ``new`` in IEEE-754.

Draws: where the reference derives keys inside the step, the port takes
them as a `FleetDraws` (``fd``), which `FleetUpdate.draw` takes from the
run's draws object: the per-device minibatch slots (the reference's
``vmap(split(ckey_i, d_max))``; the shortcut takes the users' own
slots), the edge codec noise (``uniform(fold_in(ckeys[0], 0x65646765),
shape)``) and the device-dropout coins (``bernoulli(fold_in(ekey, 1),
1 − p, shape)``), ``ckeys[0]`` being the first row the update sees.  On
the card the step reads no generator and nothing back to the host, so it
runs inside the fused engine's captured CUDA graph; the edge crossing
goes through the codec's kernel (the QSGD row pass, or the top-k
threshold) on the (m·d_max, F) device rows.
"""
from __future__ import annotations

import abc
import functools
import math
from typing import (Any, Callable, ClassVar, Dict, NamedTuple, Optional,
                    Tuple, Type)

import numpy as np
import torch

from repro_torch.fl.channel import stacked_ravel, stacked_unravel
from repro_torch.fl.placement.graphs import tree_map


class FleetDraws(NamedTuple):
    """One call's draws of a fleet update, where the flat update step
    takes its minibatch slots; a chunk's stacked (L, ...) rows of them in
    the fused engine."""
    slots: torch.Tensor               # (m, d_max, S, B) int64 device
                                      # slots of every user; (m, S, B) the
                                      # users' own on the flat-exact
                                      # shortcut
    noise: Optional[torch.Tensor]     # (rows·d_max, F) f32 edge codec
                                      # noise of the rows the update sees;
                                      # None without a noisy codec
    up: Optional[torch.Tensor]        # (rows, d_max) bool: the device's
                                      # upload survives its dropout coin;
                                      # None without device dropout

    def index_select(self, dim: int, idx: torch.Tensor) -> "FleetDraws":
        """The draws of the user rows ``idx`` (an async cohort's gather,
        as a slot tensor's ``index_select``): the slots are every user's
        and are gathered; the noise and the coins were drawn for the
        cohort's rows (`FleetUpdate.draw`'s ``row``/``rows``) and pass."""
        return self._replace(slots=self.slots.index_select(dim, idx))


class EdgeState(NamedTuple):
    """A hierarchy run's optimizer-state slot: per-device optimizer
    states (m, d_max, ...) and the per-device edge-EF residual stack
    (None for an identity edge codec).  Every leaf keeps the user axis
    first, so the engines' row-wise select, gather and scatter apply."""
    dev_opt: Any
    edge_ef: Any


class EdgeAggregator(abc.ABC):
    """How a user combines its devices' decoded updates.

    ``weights(n, mask)`` is the in-graph rule: per-device sample counts
    (m, d_max) and the participation mask -> normalized weights (rows sum
    to 1 over surviving devices, all-zero rows when a user's whole fleet
    dropped: that user keeps its previous model).  Aggregators that
    weight on the host set ``traceable=False`` and implement
    ``weights_host`` instead; the engine then runs the eventful loop.
    ``static_keep`` may bake a device-drop mask from the resolved fleet
    and rates at plan time (straggler dropping); returning one marks the
    update non-row-local, so partial async events take the full-width
    update path."""

    name: ClassVar[str]
    traceable: ClassVar[bool] = True

    @property
    def spec(self) -> str:
        return self.name

    def static_keep(self, counts: np.ndarray, valid: np.ndarray,
                    rates_dl: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """(m, d_max) bool device-keep mask resolved at plan time, or None
        (keep every valid device; the row-local default)."""
        return None

    def weights(self, n: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(m, d_max) normalized weights on the device; pure torch."""
        raise NotImplementedError(
            f"{type(self).__name__} sets traceable=True but does not "
            "implement weights")

    def weights_host(self, n: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Host-side sibling for ``traceable=False`` aggregators."""
        raise NotImplementedError(
            f"{type(self).__name__} sets traceable=False but does not "
            "implement weights_host")

    # value objects: the spec is the fleet-update cache's identity
    def __eq__(self, other) -> bool:
        return isinstance(other, EdgeAggregator) and self.spec == other.spec

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.spec))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


EDGE_AGGREGATORS: Dict[str, Type[EdgeAggregator]] = {}


def register_edge_aggregator(cls: Type[EdgeAggregator]
                             ) -> Type[EdgeAggregator]:
    EDGE_AGGREGATORS[cls.name] = cls
    return cls


@register_edge_aggregator
class MeanEdge(EdgeAggregator):
    """Sample-weighted mean over surviving devices (FedAvg at the edge):
    w_id ∝ n_id · mask_id, rows normalized; a row with no survivors
    aggregates nothing (all-zero weights)."""

    name = "mean"

    def weights(self, n, mask):
        wn = n.to(torch.float32) * mask.to(torch.float32)
        s = wn.sum(dim=1, keepdim=True)
        return torch.where(s > 0.0, wn / torch.clamp(s, min=1e-12),
                           torch.zeros_like(wn))


@register_edge_aggregator
class DropStragglers(MeanEdge):
    """Mean weighting after statically dropping each user's slowest
    ``frac`` of devices (never its last one): ranked by edge downlink
    rate when an edge link is resolved, by device index (tail first)
    otherwise.  The keep mask is baked per user at plan time, so partial
    async events take the full-width update path (``row_local=False``)."""

    name = "drop_stragglers"

    def __init__(self, frac: float = 0.5):
        if not 0.0 <= float(frac) < 1.0:
            raise ValueError("drop_stragglers frac must be in [0, 1), "
                             f"got {frac}")
        self.frac = float(frac)

    @property
    def spec(self) -> str:
        return f"{self.name}:{self.frac:g}"

    def static_keep(self, counts, valid, rates_dl):
        keep = np.asarray(valid, bool).copy()
        for i in range(keep.shape[0]):
            c = int(counts[i])
            n_drop = min(c - 1, int(math.floor(self.frac * c)))
            if n_drop <= 0:
                continue
            devs = np.arange(c)
            if rates_dl is not None:
                order = devs[np.argsort(rates_dl[i, :c], kind="stable")]
            else:
                order = devs[::-1]
            keep[i, order[:n_drop]] = False
        return keep


def get_edge_aggregator(spec) -> EdgeAggregator:
    """``"mean" | "drop_stragglers:<frac>"`` -> EdgeAggregator (instances
    pass through)."""
    if isinstance(spec, EdgeAggregator):
        return spec
    family, _, param = str(spec).partition(":")
    cls = EDGE_AGGREGATORS.get(family)
    if cls is None:
        raise ValueError(f"unknown edge aggregator {spec!r}; one of "
                         f"{sorted(EDGE_AGGREGATORS)}")
    if not param:
        return cls()
    try:
        return cls(float(param))
    except TypeError:
        raise ValueError(f"edge aggregator {family!r} takes no "
                         "parameter") from None
    except ValueError as e:
        if "could not convert" in str(e):
            raise ValueError(
                f"bad edge-aggregator parameter in {spec!r}") from None
        raise


# ---------------------------------------------------------------------------
# the fleet update step


def _merge(tree: Any) -> Any:
    """(m, d_max, ...) leaves -> (m·d_max, ...): one row a device."""
    return tree_map(lambda l: l.reshape((-1,) + tuple(l.shape[2:])), tree)


def _split(tree: Any, m: int, d_max: int) -> Any:
    """Inverse of `_merge`."""
    return tree_map(lambda l: l.reshape((m, d_max) + tuple(l.shape[1:])),
                    tree)


def _squeeze(tree: Any) -> Any:
    return tree_map(lambda l: l.reshape((l.shape[0],) + tuple(l.shape[2:])),
                    tree)


def _unsqueeze(tree: Any) -> Any:
    return tree_map(lambda l: l.reshape((l.shape[0], 1) + tuple(l.shape[1:])),
                    tree)


def combine(stacked: Any, dec: Any, w: torch.Tensor) -> Any:
    """The user's new model: ``p + Σ_d w_d · dec_d`` over its devices."""
    wf = w.to(torch.float32)
    out = {}
    for k, p in stacked.items():
        dl = dec[k]
        wexp = wf.reshape(tuple(wf.shape) + (1,) * (dl.dim() - 2))
        out[k] = (p + torch.sum(wexp * dl, dim=1)).to(p.dtype)
    return out


class FleetUpdate:
    """The edge sub-round as one engine-shaped update step; see the module
    docstring.  ``plan`` is the resolved `FleetPlan`, ``client_update``
    the per-row local-SGD step (`placement.host.ClientUpdate`),
    ``edge_hook`` a weight refiner (`Strategy.edge_weights`, passed only
    when a strategy overrides it), ``backend`` the placement's codec
    backend and ``users`` the [lo, hi) users whose rows the step sees (a
    mesh rank's; the static straggler mask is cut to them).
    ``shortcut`` says whether the step is the flat per-user step on
    squeezed views."""

    def __init__(self, plan: Any, client_update: Callable,
                 edge_hook: Optional[Callable] = None, *,
                 backend: str = "pallas",
                 users: Optional[Tuple[int, int]] = None):
        self.plan = plan
        self.codec = plan.codec
        self.backend = backend
        self.agg = plan.cfg.edge_aggregator
        self.edge_hook = edge_hook
        self._client_update = client_update
        # the edge latency and link stay out of the condition: they are
        # meter-only and never touch the values
        self.shortcut = plan.flat_exact and edge_hook is None
        if not self.agg.traceable and edge_hook is not None:
            raise ValueError(
                f"strategy edge_weights hooks run on the device; edge "
                f"aggregator {self.agg.spec!r} weights on the host "
                "(traceable=False)")
        # made once, on the run's device: a captured round copies nothing
        # from the host
        keep = plan.keep
        if keep is not None and users is not None:
            keep = keep[users[0]:users[1]]
        self._keep = (None if keep is None
                      else torch.as_tensor(keep, device=plan.device))

    def draw(self, draws: Any, rnd: int, x: torch.Tensor, n: torch.Tensor,
             *, row: int = 0, rows: Optional[int] = None) -> FleetDraws:
        """This step's `FleetDraws` for round (or async event) ``rnd``, on
        ``x``'s device: ``n`` is every user's (m, d_max) device sample
        counts, ``row`` and ``rows`` the first user and the number of
        users the step sees (an async event's gathered cohort; default
        all m).  The slots are drawn for all m users, as the flat engines
        draw theirs."""
        if self.shortcut:
            # the flat run's own draw: the users' slots over the flat n
            return FleetDraws(self._client_update.draw(
                draws, rnd, _squeeze(x), n[:, 0]), None, None)
        m, d_max = n.shape
        rows = m if rows is None else rows
        cu, device = self._client_update, x.device
        slots = draws.device_batch_indices(rnd, n, x.shape[2], cu.batch_size,
                                           cu.local_steps).to(device)
        noise = up = None
        if not self.codec.is_identity and self.codec.needs_noise:
            noise = draws.edge_noise(rnd, m, row,
                                     (rows * d_max, self.plan.dim)
                                     ).to(device)
        p = float(self.plan.cfg.device_dropout)
        if p > 0.0:
            up = draws.device_dropout(rnd, m, row, (rows, d_max),
                                      p).to(device)
        return FleetDraws(slots, noise, up)

    def device_phase(self, stacked: Any, est: EdgeState, x: torch.Tensor,
                     y: torch.Tensor, n: torch.Tensor, fd: FleetDraws):
        """Per-device local updates and the edge channel crossing: returns
        (new device opt, decoded per-device deltas, new edge EF, mask)."""
        m, d_max = n.shape
        dev_prev = {k: l[:, None].expand((m, d_max) + tuple(l.shape[1:]))
                    .reshape((m * d_max,) + tuple(l.shape[1:]))
                    for k, l in stacked.items()}
        new_dev, new_opt = self._client_update(
            dev_prev, _merge(est.dev_opt), _merge(x), _merge(y), _merge(n),
            _merge(fd.slots))
        delta = {k: new_dev[k] - dev_prev[k] for k in new_dev}
        if self.codec.is_identity:
            dec, new_ef = _split(delta, m, d_max), est.edge_ef
        else:
            # the user→server hop's EF algebra on the (m·d_max, F)
            # device-flat view: each device is one codec row
            ef = _merge(est.edge_ef)
            v = {k: delta[k] + ef[k] for k in delta}
            dec = stacked_unravel(
                self.codec.roundtrip(stacked_ravel(v), fd.noise,
                                     backend=self.backend), v)
            new_ef = (_split({k: v[k] - dec[k] for k in v}, m, d_max)
                      if self.plan.cfg.edge_error_feedback
                      else est.edge_ef)
            dec = _split(dec, m, d_max)
        # validity is derived from n > 0 (row-local: it survives the async
        # cohort gather); the static straggler mask marks the plan
        # non-row-local, so async partial events go full width
        mask = n > 0
        if self._keep is not None:
            mask = mask & self._keep
        if fd.up is not None:
            mask = mask & fd.up
        return _split(new_opt, m, d_max), dec, new_ef, mask

    def __call__(self, stacked: Any, est: EdgeState, x: torch.Tensor,
                 y: torch.Tensor, n: torch.Tensor,
                 fd: FleetDraws) -> tuple:
        if self.shortcut:
            new_p, new_o = self._client_update(
                stacked, _squeeze(est.dev_opt), _squeeze(x), _squeeze(y),
                n[:, 0], fd.slots)
            return new_p, EdgeState(_unsqueeze(new_o), est.edge_ef)
        new_opt, dec, new_ef, mask = self.device_phase(stacked, est, x, y,
                                                       n, fd)
        if self.agg.traceable:
            w = self.agg.weights(n, mask)
            if self.edge_hook is not None:
                w = self.edge_hook(w, n)
        else:
            # the eventful route of a host-side aggregator: `superstep_
            # support` keeps such a run out of the captured chunk
            w = torch.from_numpy(np.asarray(self.agg.weights_host(
                n.cpu().numpy(), mask.cpu().numpy()), np.float32)
            ).to(n.device)
        return combine(stacked, dec, w), EdgeState(new_opt, new_ef)


def build_fleet_update(plan: Any, client_update: Callable, *, backend: str,
                       edge_hook: Optional[Callable] = None,
                       donate: bool = False) -> FleetUpdate:
    """The edge sub-round as one engine-shaped update step: the
    reference's factory under its name and signature, building the
    `FleetUpdate` the engines run.  ``plan`` is the resolved `FleetPlan`,
    ``client_update`` the per-row step (`placement.host.
    make_client_update`), ``edge_hook`` a traced weight refiner.  Where
    the reference's step derives its keys inside, this one takes them as
    a `FleetDraws` (`FleetUpdate.draw`).  ``donate`` (XLA's buffer
    donation) has no counterpart: the step is functional and allocates
    its outputs; it is accepted and ignored.  The step sees every user's
    rows (a mesh rank's cut is `cached_fleet_update`'s ``users``)."""
    del donate
    return FleetUpdate(plan, client_update, edge_hook, backend=backend)


@functools.lru_cache(maxsize=16)
def cached_fleet_update(loss_fn: Callable, local_steps: int, batch_size: int,
                        lr: float, momentum: float, state_dtype, plan: Any,
                        edge_hook: Optional[Callable] = None,
                        backend: str = "pallas",
                        users: Optional[Tuple[int, int]] = None):
    """(opt, fleet update step) memoized like `placement.host.
    cached_update`: the plan's hash holds the fleet's shape, the static
    keep mask, the bound edge codec and the device, so two runs over
    different fleets never share a step, while runs of one configuration
    reuse theirs.  The step's identity keys the superstep cache, so each
    hierarchy configuration gets its own captured graph."""
    from repro_torch.fl.placement.host import (_UpdateConfig,
                                               make_client_update)
    from repro_torch.optim import sgd
    opt = sgd(lr, momentum=momentum, state_dtype=state_dtype)
    client_update = make_client_update(loss_fn, opt,
                                       _UpdateConfig(local_steps, batch_size))
    return opt, FleetUpdate(plan, client_update, edge_hook, backend=backend,
                            users=users)
