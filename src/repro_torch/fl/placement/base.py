"""Placement protocol: where clients live and how their models move.

Counterpart of `repro/fl/placement/base.py`, with the hooks the eventful
round engine uses: build the local-update step, stack the common
initialization into the client-stacked dict, place the data, roll back
non-participants, pass the uplink through the channel codec, apply a
mixing matrix or a `StreamPlan`, and evaluate the personalized models.
Strategies route every mix through `RoundContext.mix` / `mix_plan`,
which dispatch here.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch

from repro_torch.core.streams import StreamPlan
from repro_torch.data.federated import FederatedData


def stack_params(params: Dict[str, torch.Tensor], m: int
                 ) -> Dict[str, torch.Tensor]:
    """Broadcast a single-model dict to the (m, ...) client stack."""
    return {k: v[None].expand((m,) + tuple(v.shape)).clone()
            for k, v in params.items()}


def where_clients(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-client select over stacked trees (leading dim m): nested dicts
    such as the optimizer state ``{"mu": {...} or None, "step": (m,)}``
    keep their structure, None stays None."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: where_clients(mask, a, old[k]) for k, a in new.items()}
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


class Placement(abc.ABC):
    """One client-placement backend; see module docstring."""

    name: ClassVar[str]

    @abc.abstractmethod
    def build_update(self, loss_fn: Callable, fl: Any) -> Tuple[Any, Callable]:
        """Returns ``(opt, update_fn)`` where ``update_fn(stacked, opt_state,
        x, y, idx) -> (stacked', opt_state')`` runs every client's local
        SGD on the minibatch slots ``idx`` (m, local_steps, batch_size)."""

    @abc.abstractmethod
    def stack(self, params0: Dict[str, torch.Tensor], m: int) -> Any:
        """Place the common initialization as the (m, ...) client stack."""

    def init_opt(self, opt: Any, stacked: Any) -> Any:
        m = next(iter(stacked.values())).shape[0]
        return opt.init_stacked(stacked, m)

    def place_data(self, fed: FederatedData) -> Tuple[Any, Any, Any]:
        """Place the stacked client train arrays ``(x, y, n)``."""
        return fed.x, fed.y, fed.n

    def select(self, mask: torch.Tensor, new: Any, old: Any) -> Any:
        """Participation rollback: keep ``old`` where ``mask`` is False."""
        return where_clients(mask, new, old)

    def uplink(self, codec: Any, stacked: Any, prev: Any, ef: Any,
               noise: Optional[torch.Tensor],
               mask: Optional[torch.Tensor] = None) -> Tuple[Any, Any]:
        """Pass the participating clients' updates through the channel
        codec with error feedback: returns the server-side ``(stacked',
        ef')``.  Rows where ``mask`` is False are untouched; an identity
        codec returns the inputs unchanged."""
        from repro_torch.fl.channel import apply_uplink
        return apply_uplink(codec, stacked, prev, ef, noise, mask)

    @abc.abstractmethod
    def mix(self, stacked: Any, w: torch.Tensor) -> Any:
        """Apply a full per-client aggregation matrix ``w`` (m, m)."""

    @abc.abstractmethod
    def mix_plan(self, stacked: Any, plan: StreamPlan) -> Any:
        """Apply a k-stream `StreamPlan` (centroid mix + group broadcast)."""

    @abc.abstractmethod
    def evaluate(self, acc_fn: Callable, stacked: Any, fed: FederatedData
                 ) -> Tuple[float, float]:
        """(mean, worst) validation score across clients."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


def resolve_placement(placement: Optional[Placement]) -> Placement:
    """None -> the default `HostVmap` backend."""
    if placement is None:
        from repro_torch.fl.placement.host import HostVmap
        return HostVmap()
    return placement
