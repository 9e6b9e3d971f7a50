"""Functional SGD with momentum over parameter dicts.

Counterpart of `repro/optim/optim.py` (`sgd`, `apply_updates`; the other
optimizers and the schedules wait for the slices that use them):

    opt = sgd(lr=0.1, momentum=0.9)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Every operation is elementwise, so the same functions serve one model or
a client-stacked dict whose leaves carry a leading client dim (then
``init_stacked`` gives the step counter that leading dim too).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)
    init_stacked: Callable[[Any, int], Any]


def sgd(lr: float, momentum: float = 0.0,
        state_dtype: Optional[str] = None) -> Optimizer:
    """Momentum SGD: fp32 ``mu = momentum·mu + g``, update ``−lr·mu``.
    state_dtype: None = float32 momentum; "param" = momentum in the
    param dtype (updated in fp32, stored rounded)."""
    if state_dtype not in (None, "param"):
        raise ValueError(f"state_dtype must be None or 'param', got "
                         f"{state_dtype!r}")

    def _mu(params):
        if not momentum:
            return None
        if state_dtype == "param":
            return {k: torch.zeros_like(p) for k, p in params.items()}
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def init(params):
        device = next(iter(params.values())).device
        return {"mu": _mu(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def init_stacked(stacked, m: int):
        device = next(iter(stacked.values())).device
        return {"mu": _mu(stacked),
                "step": torch.zeros((m,), dtype=torch.int32, device=device)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        if momentum:
            mu = {k: (momentum * m.float() + grads[k].float()).to(m.dtype)
                  for k, m in state["mu"].items()}
            updates = {k: -lr * m.float() for k, m in mu.items()}
        else:
            mu = None
            updates = {k: -lr * g.float() for k, g in grads.items()}
        return updates, {"mu": mu, "step": step}

    return Optimizer(init, update, init_stacked)


def apply_updates(params, updates):
    return {k: (p.float() + updates[k]).to(p.dtype)
            for k, p in params.items()}
