"""Single-device stacked-client placement (reference semantics).

Counterpart of `repro/fl/placement/host.py`: all clients live in one
stacked param dict on one device; the local update is ``local_steps``
momentum-SGD steps, each one `torch.func.vmap(grad(loss_fn))` over the
clients, and the mix goes through `core.aggregation` (the Y = W Θ kernel
on CUDA).  An async event updates only its cohort's rows
(`HostVmap.update_cohort`: gather, update, scatter).  The update step
is cached across calls on what it closes over, as the reference caches
its jitted step, so the superstep cache (keyed on the step) serves
repeated `run_federated` calls.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.core.aggregation import (stream_aggregate,
                                          user_centric_aggregate)
from repro_torch.core.streams import StreamPlan
from repro_torch.data.federated import FederatedData
from repro_torch.fl.placement.base import (Placement, client_scores,
                                           stack_params, where_clients)
from repro_torch.fl.placement.graphs import tree_map
from repro_torch.optim import apply_updates, sgd


class ClientUpdate:
    """The per-client local-SGD step, ``update(stacked, opt_state, x, y,
    n, idx)``: ``fl.local_steps`` SGD steps for every client, step s on
    the slots ``idx[:, s]``.  ``n`` is unused (the slots already hold the
    sample-count rule); it is there so that every update step, a
    hierarchy run's fleet update included, takes the same ``(x, y, n,
    draw)``.  The update is functional: the caller's ``stacked`` and
    ``opt_state`` are left as they were."""

    def __init__(self, loss_fn: Callable, opt, fl):
        self.opt = opt
        self.local_steps = fl.local_steps
        self.batch_size = fl.batch_size
        self._vgrad = vmap(grad(loss_fn, has_aux=True))

    def draw(self, draws, rnd: int, x: torch.Tensor, n: torch.Tensor, *,
             row: int = 0, rows=None) -> torch.Tensor:
        """Round (or async event) ``rnd``'s (m, S, B) minibatch slots of
        every client, on ``x``'s device.  ``row`` and ``rows`` (the rows
        an async cohort update sees) do not apply: a cohort update
        gathers its rows of the slots (`HostVmap.update_cohort`)."""
        return draws.batch_indices(rnd, n, x.shape[1], self.batch_size,
                                   self.local_steps).to(x.device)

    def __call__(self, stacked, opt_state, x, y, n, idx):
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        p, o = stacked, opt_state
        for s in range(self.local_steps):
            slots = idx[:, s]                  # (m, B), explicit client dim
            grads, _ = self._vgrad(p, {"x": x[rows, slots],
                                       "y": y[rows, slots]})
            upd, o = self.opt.update(grads, o, p)
            p = apply_updates(p, upd)
        return p, o


def make_client_update(loss_fn: Callable, opt, fl) -> ClientUpdate:
    """The local-SGD step of every client: the reference's factory under
    its name and signature, building the `ClientUpdate` the engines run.
    The reference's step is one client's, ``f(params_i, opt_i, x_i, y_i,
    n_i, key)``, vmapped by the engine, and draws its minibatches from
    ``key``; this one takes the whole stack and the drawn slots,
    ``f(stacked, opt_state, x, y, n, idx)``, ``idx`` from
    `ClientUpdate.draw` (the run's `TorchDraws`, or injected indices)."""
    return ClientUpdate(loss_fn, opt, fl)


class _UpdateConfig:
    """The FLConfig fields `ClientUpdate` closes over."""

    def __init__(self, local_steps: int, batch_size: int):
        self.local_steps = local_steps
        self.batch_size = batch_size


@functools.lru_cache(maxsize=16)
def cached_update(loss_fn: Callable, local_steps: int, batch_size: int,
                  lr: float, momentum: float,
                  state_dtype=None) -> Tuple[Any, Callable]:
    """(opt, update) memoized on everything the step closes over."""
    opt = sgd(lr, momentum=momentum, state_dtype=state_dtype)
    return opt, make_client_update(loss_fn, opt,
                                   _UpdateConfig(local_steps, batch_size))


def score_stats(accs: torch.Tensor) -> torch.Tensor:
    """(2,) device tensor: mean and min of the per-client score vector;
    both engines reduce their device scores through it."""
    return torch.stack((accs.mean(), accs.min()))


def reduce_scores(accs: torch.Tensor) -> Tuple[float, float]:
    """(mean, worst) of the per-client score vector, in one copy to the
    host."""
    mean, worst = score_stats(accs).tolist()
    return mean, worst


def evaluate(acc_fn: Callable, stacked, fed: FederatedData
             ) -> Tuple[float, float]:
    """(mean, worst) validation accuracy across clients, personalized models."""
    return reduce_scores(client_scores(acc_fn, stacked, fed.x_val,
                                       fed.y_val))


class HostVmap(Placement):
    """Single-device stacked-client placement."""

    name = "host_vmap"

    def build_update(self, loss_fn: Callable, fl) -> Tuple[Any, Callable]:
        return cached_update(loss_fn, fl.local_steps, fl.batch_size, fl.lr,
                             fl.momentum,
                             getattr(fl, "opt_state_dtype", None))

    def stack(self, params0, m: int):
        return stack_params(params0, m)

    def update_cohort(self, update_fn, idx, keep, stacked, opt_state,
                      x, y, n, batch_idx):
        # gather the k cohort rows, update them, scatter the kept ones
        # back (out of place: the caller's stacked is the event's prev):
        # an event's local update costs O(k), not O(m); the draw gathers
        # its own rows (a plain slot tensor, or a hierarchy run's
        # `FleetDraws`, whose edge draws are already the cohort's)
        take = lambda t: tree_map(lambda a: a.index_select(0, idx), t)
        sub, sub_opt = take(stacked), take(opt_state)
        new_sub, new_opt = update_fn(sub, sub_opt, *take((x, y, n)),
                                     batch_idx.index_select(0, idx))
        new_sub = where_clients(keep, new_sub, sub)
        new_opt = where_clients(keep, new_opt, sub_opt)
        scatter = lambda full, part: tree_map(
            lambda a, b: a.index_copy(0, idx, b), full, part)
        return scatter(stacked, new_sub), scatter(opt_state, new_opt)

    def mix(self, stacked, w: torch.Tensor):
        return user_centric_aggregate(stacked, w)

    def mix_plan(self, stacked, plan: StreamPlan):
        return stream_aggregate(stacked, plan)

    def evaluate(self, acc_fn: Callable, stacked, fed: FederatedData
                 ) -> Tuple[float, float]:
        return evaluate(acc_fn, stacked, fed)
