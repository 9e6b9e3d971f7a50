"""Functional optimizers over parameter dicts: SGD-momentum, AdamW, the
learning-rate schedules and global-norm clipping.

Counterpart of `repro/optim/optim.py`:

    opt = sgd(lr=0.1, momentum=0.9)          # the paper's optimizer
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Learning rates may be floats or schedules (callables step -> lr); state
carries the step counter.  Every operation is elementwise, so the same
functions serve one model or a client-stacked dict whose leaves carry a
leading client dim (then ``init_stacked`` gives the step counter that
leading dim too, and a schedule's (m,) rate scales each client's rows).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]
LR = Union[float, Schedule]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params) -> (updates, state)
    init_stacked: Callable[[Any, int], Any]


def _lr_at(lr: LR, step: torch.Tensor):
    """A schedule's f32 rate at ``step``, or the float as it is."""
    return lr(step) if callable(lr) else lr


def _rowwise(s, like: torch.Tensor):
    """A per-client (m,) tensor shaped to scale ``like``'s (m, ...) rows;
    a float or a 0-d tensor as it is."""
    if isinstance(s, torch.Tensor) and s.dim():
        return s.reshape((-1,) + (1,) * (like.dim() - 1))
    return s


def _device(params) -> torch.device:
    return next(iter(params.values())).device


def _step(params, m: Optional[int]) -> torch.Tensor:
    shape = () if m is None else (m,)
    return torch.zeros(shape, dtype=torch.int32, device=_device(params))


def _zeros_f32(params):
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def sgd(lr: LR, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0,
        state_dtype: Optional[str] = None) -> Optimizer:
    """Momentum SGD on the fp32 effective gradient ``g + wd·p``: ``mu =
    momentum·mu + g_eff``, update ``−lr·mu`` (Nesterov: ``−lr·(g_eff +
    momentum·mu)``).  state_dtype: None = float32 momentum; "param" =
    momentum in the param dtype (updated in fp32, stored rounded)."""
    if state_dtype not in (None, "param"):
        raise ValueError(f"state_dtype must be None or 'param', got "
                         f"{state_dtype!r}")

    def _mu(params):
        if not momentum:
            return None
        if state_dtype == "param":
            return {k: torch.zeros_like(p) for k, p in params.items()}
        return _zeros_f32(params)

    def init(params):
        return {"mu": _mu(params), "step": _step(params, None)}

    def init_stacked(stacked, m: int):
        return {"mu": _mu(stacked), "step": _step(stacked, m)}

    def eff_grad(k, grads, params):
        g = grads[k].float()
        if weight_decay and params is not None:
            g = g + weight_decay * params[k].float()
        return g

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = {k: (momentum * m.float() + eff_grad(k, grads, params)
                      ).to(m.dtype) for k, m in state["mu"].items()}
            if nesterov:
                updates = {k: -_rowwise(lr_t, m) * (
                    eff_grad(k, grads, params) + momentum * m.float())
                    for k, m in mu.items()}
            else:
                updates = {k: -_rowwise(lr_t, m) * m.float()
                           for k, m in mu.items()}
        else:
            mu = None
            updates = {k: -_rowwise(lr_t, g) * eff_grad(k, grads, params)
                       for k, g in grads.items()}
        return updates, {"mu": mu, "step": step}

    return Optimizer(init, update, init_stacked)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with fp32 moments and bias correction, decoupled decay."""
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "step": _step(params, None)}

    def init_stacked(stacked, m: int):
        return {"m": _zeros_f32(stacked), "v": _zeros_f32(stacked),
                "step": _step(stacked, m)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        c1 = 1.0 - torch.pow(b1, step.float())
        c2 = 1.0 - torch.pow(b2, step.float())
        m = {k: b1 * mm + (1 - b1) * grads[k].float()
             for k, mm in state["m"].items()}
        v = {k: b2 * vv + (1 - b2) * torch.square(grads[k].float())
             for k, vv in state["v"].items()}
        updates = {k: -_rowwise(lr_t, mm) * (
            (mm / _rowwise(c1, mm))
            / (torch.sqrt(v[k] / _rowwise(c2, mm)) + eps)
            + weight_decay * params[k].float()) for k, mm in m.items()}
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update, init_stacked)


def apply_updates(params, updates):
    return {k: (p.float() + updates[k]).to(p.dtype)
            for k, p in params.items()}


# ---------------------------------------------------------------------------
# schedules


def constant(value: float) -> Schedule:
    return lambda step: torch.full(step.shape, value, dtype=torch.float32,
                                   device=step.device)


def cosine_decay(peak: float, total_steps: int, final_frac: float = 0.1
                 ) -> Schedule:
    def fn(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_decay(peak, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        s = step.float()
        wu = peak * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, wu, cos(step - warmup_steps))
    return fn


def _leaves(tree):
    """Tensors of nested dicts / lists / tuples, dict keys sorted (the
    order of `jax.tree_util.tree_leaves`)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping), over a dict of tensors."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    # the scale is f32: a bf16 leaf comes back f32, as in the reference
    return {k: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
            for k, g in grads.items()}, norm
