"""Single-device stacked-client placement (reference semantics).

Counterpart of `repro/fl/placement/host.py`: all clients live in one
stacked param dict on one device; the local update is ``local_steps``
momentum-SGD steps, each one `torch.func.vmap(grad(loss_fn))` over the
clients, and the mix goes through `core.aggregation` (the Y = W Θ kernel
on CUDA).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core.aggregation import (stream_aggregate,
                                          user_centric_aggregate)
from repro_torch.core.streams import StreamPlan
from repro_torch.data.federated import FederatedData
from repro_torch.fl.placement.base import Placement, stack_params
from repro_torch.optim import apply_updates, sgd


def make_client_update(loss_fn: Callable, opt, fl) -> Callable:
    """Returns ``update(stacked, opt_state, x, y, idx)`` running
    ``fl.local_steps`` SGD steps for every client, step s on the slots
    ``idx[:, s]``.  The update is functional: the caller's ``stacked`` and
    ``opt_state`` are left as they were."""
    vgrad = vmap(grad(loss_fn, has_aux=True))

    def update(stacked, opt_state, x, y, idx):
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        p, o = stacked, opt_state
        for s in range(fl.local_steps):
            slots = idx[:, s]                  # (m, B), explicit client dim
            grads, _ = vgrad(p, {"x": x[rows, slots], "y": y[rows, slots]})
            upd, o = opt.update(grads, o, p)
            p = apply_updates(p, upd)
        return p, o

    return update


def reduce_scores(accs: torch.Tensor) -> Tuple[float, float]:
    """(mean, worst) of the per-client score vector."""
    return float(accs.mean()), float(accs.min())


@torch.no_grad()
def evaluate(acc_fn: Callable, stacked, fed: FederatedData
             ) -> Tuple[float, float]:
    """(mean, worst) validation accuracy across clients, personalized models."""
    accs = vmap(lambda p, x, y: acc_fn(p, {"x": x, "y": y}))(
        stacked, fed.x_val, fed.y_val)
    return reduce_scores(accs)


class HostVmap(Placement):
    """Single-device stacked-client placement."""

    name = "host_vmap"

    def build_update(self, loss_fn: Callable, fl) -> Tuple[Any, Callable]:
        opt = sgd(fl.lr, momentum=fl.momentum,
                  state_dtype=getattr(fl, "opt_state_dtype", None))
        return opt, make_client_update(loss_fn, opt, fl)

    def stack(self, params0, m: int):
        return stack_params(params0, m)

    def mix(self, stacked, w: torch.Tensor):
        return user_centric_aggregate(stacked, w)

    def mix_plan(self, stacked, plan: StreamPlan):
        return stream_aggregate(stacked, plan)

    def evaluate(self, acc_fn: Callable, stacked, fed: FederatedData
                 ) -> Tuple[float, float]:
        return evaluate(acc_fn, stacked, fed)
