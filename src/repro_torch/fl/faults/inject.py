"""Deterministic seeded fault injection.

Counterpart of `repro/fl/faults/inject.py`, fed by drawn tensors rather
than keys: the engine takes a round's `fl.draws.FaultDraws` from its
draws object (``draws.fault_draws``; the reference derives them from
``fold_in(kround, 3)``), and these functions only read them, so they run
unchanged inside a fused round (a captured CUDA graph on the card).  A
fault axis whose rate is 0 draws nothing and does nothing.

The value path works on the (m, D) flat delta view (`stacked_ravel`):
Byzantine scaling, NaN rows and bit-rot all corrupt WHAT THE CLIENT
TRANSMITS (Δ = update − prev), never the client's own resident state;
crash is the only fault that touches the client row itself (rollback to
``prev``/``prev_opt``, exactly a sampler no-show).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.fl.channel.payload import stacked_ravel, stacked_unravel
from repro_torch.fl.draws import FaultDraws
from repro_torch.fl.faults.config import FaultPlan


def crash_mask(plan: Optional[FaultPlan],
               fd: Optional[FaultDraws]) -> Optional[torch.Tensor]:
    """(m,) bool: True where the client crashes this round; None when
    crashes are off."""
    if plan is None or plan.cfg.crash <= 0.0:
        return None
    return fd.crash


def inject_values(plan: FaultPlan, byz_row: torch.Tensor, stacked: Any,
                  prev: Any, fd: FaultDraws,
                  rows: Optional[torch.Tensor] = None) -> Any:
    """Apply the value faults (Byzantine scale/flip, bit-rot, NaN, in the
    reference's order) to the transmitted update.  ``byz_row`` is the
    plan's (m,) f32 adversary indicator on the device; ``rows``
    optionally restricts every fault to the rows that transmit this round
    (the sampler's participants)."""
    if not plan.value_faults:
        return stacked
    cfg = plan.cfg
    flat_prev = stacked_ravel(prev)
    delta = stacked_ravel(stacked) - flat_prev
    m = delta.shape[0]

    hit = (torch.ones((m,), dtype=torch.bool, device=delta.device)
           if rows is None else rows.to(torch.bool))
    byz = (byz_row > 0.0) & hit
    factor = -cfg.byz_scale if cfg.byz_mode == "sign_flip" else cfg.byz_scale
    delta = torch.where(byz[:, None], delta * float(factor), delta)

    if cfg.bitrot > 0.0:
        rot = fd.rot & hit
        # one IEEE-754 bit flipped through the int32 view; bit 31 shifts
        # to INT_MIN, the sign bit, as in XLA
        one = torch.ones_like(fd.bit)
        flipped = (delta.view(torch.int32)
                   ^ torch.bitwise_left_shift(one, fd.bit)).view(
                       torch.float32)
        delta = torch.where(rot[:, None] & fd.elem, flipped, delta)

    if cfg.nan > 0.0:
        bad = fd.nan & hit
        delta = torch.where(bad[:, None],
                            torch.full((), float("nan"), device=delta.device),
                            delta)

    return stacked_unravel(flat_prev + delta, stacked)
