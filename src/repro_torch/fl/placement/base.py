"""Placement protocol: where clients live and how their models move.

Counterpart of `repro/fl/placement/base.py`, with the hooks the eventful
round engine uses: build the local-update step, stack the common
initialization into the client-stacked dict, place the data, apply a
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


def where_clients(mask: torch.Tensor, new: Dict[str, torch.Tensor],
                  old: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-client select over stacked dicts (leading dim m)."""
    return {k: torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                           a, old[k]) for k, a in new.items()}


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
