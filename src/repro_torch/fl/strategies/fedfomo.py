"""FedFOMO (Zhang et al. 2020): client-side first-order model optimization.

Counterpart of `repro/fl/strategies/fedfomo.py`.  Each client evaluates
candidate models on its own validation set and mixes the ones that
reduce its loss; the server therefore unicasts candidate models (no
broadcast sharing is possible).

The candidate-loss matrix is ONE batched (m, m) evaluation on the device
(a vmap over candidate models of the vmap over client validation sets).
Orientation: ``losses[i, j]`` is candidate j's loss on client i's OWN
validation set, ``prev_losses[i]`` client i's pre-round model on its own
set.  The whole weighting (`fomo_weights`) is torch on the device with
no read back to the host, so FedFOMO is traceable: the eventful loop and
the fused round (a captured CUDA graph on the card) run the same
function.  The top-M cut takes the candidate count as a device int
scalar and reads the threshold with ``gather`` (the reference's
``dynamic_slice``), so runs that differ only in ``candidates`` share one
graph.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from repro_torch.fl.channel.payload import stacked_ravel
from repro_torch.fl.strategies.base import CommCost, RoundContext, Strategy
from repro_torch.fl.strategies.registry import register


class FomoState(NamedTuple):
    x_val: torch.Tensor         # the per-client validation sets the
    y_val: torch.Tensor         # weighting evaluates candidates on
    n_cand: torch.Tensor        # top-M cut, a 0-d int64 tensor on the device
    m: int
    candidates: int


def candidate_losses(loss_fn: Callable, stacked, x_val, y_val
                     ) -> torch.Tensor:
    """(m, m): ``[i, j]`` is candidate model j's loss on client i's
    validation set, one batched evaluation (computed (candidate, client)
    and transposed, as the reference does)."""
    per_client = vmap(lambda p, x, y: loss_fn(p, {"x": x, "y": y})[0],
                      in_dims=(None, 0, 0))
    return vmap(per_client, in_dims=(0, None, None))(stacked, x_val,
                                                     y_val).T


def self_losses(loss_fn: Callable, stacked, x_val, y_val) -> torch.Tensor:
    """(m,): model i's loss on client i's own validation set."""
    return vmap(lambda p, x, y: loss_fn(p, {"x": x, "y": y})[0])(
        stacked, x_val, y_val)


@torch.no_grad()
def fomo_weights(loss_fn: Callable, stacked, prev, x_val, y_val,
                 n_cand: torch.Tensor):
    """The FedFOMO weighting: the row-normalized (m, m) mixing matrix and
    the (m,) residual mass each client keeps on its own pre-round model.

    ``n_cand`` is a 0-d int tensor on the device; ``n_cand >= m``
    disables the top-M cut (every positive-weight candidate is kept)."""
    losses = candidate_losses(loss_fn, stacked, x_val, y_val)
    prev_losses = self_losses(loss_fn, prev, x_val, y_val)
    flat = stacked_ravel(stacked)
    flat_prev = stacked_ravel(prev)
    dist = torch.linalg.vector_norm(flat[None, :, :] - flat_prev[:, None, :],
                                    dim=-1) + 1e-9
    wmat = torch.maximum((prev_losses[:, None] - losses) / dist,
                         torch.zeros((), dtype=losses.dtype,
                                     device=losses.device))
    # keep the top candidates per client (the paper samples M models):
    # threshold at the n_cand-th largest weight of each row, gathered at a
    # device index so the count never reaches the host
    m = wmat.shape[0]
    srt = torch.sort(wmat, dim=1).values
    pos = torch.clamp(m - n_cand, 0, m - 1).reshape(1, 1).expand(m, 1)
    thresh = srt.gather(1, pos)
    wmat = torch.where((n_cand >= m) | (wmat >= thresh), wmat,
                       torch.zeros_like(wmat))
    rows = wmat.sum(dim=1, keepdim=True)
    wmat = torch.where(rows > 0, wmat / torch.clamp(rows, min=1e-9),
                       torch.zeros_like(wmat))
    return wmat, 1.0 - wmat.sum(dim=1)


def _add_residual(mixed, prev, keep):
    # θ_i ← Σ_j w_ij θ_j + (1 − Σ_j w_ij) θ_i^prev
    return {k: mx + keep.reshape((-1,) + (1,) * (prev[k].dim() - 1))
            * prev[k] for k, mx in mixed.items()}


@register
class FedFOMO(Strategy):
    name = "fedfomo"
    reads_prev = True       # candidate weighting compares against prev
    traceable = True        # device-only weighting: fuses into the chunk

    def __init__(self, candidates: Optional[int] = None):
        self.candidates = candidates   # None -> FLConfig.fomo_candidates
        self._loss_fn = None           # bound at setup, for the fused round

    def setup(self, ctx: RoundContext) -> FomoState:
        n_cand = (self.candidates if self.candidates is not None
                  else ctx.fl.fomo_candidates)
        # the fused round closes over the loss function; the superstep
        # cache key carries the same identity through the cached update
        # step, so keeping it on the instance cannot alias two rounds
        self._loss_fn = ctx.loss_fn
        dev = ctx.fed.x_val.device
        return FomoState(x_val=ctx.fed.x_val, y_val=ctx.fed.y_val,
                         n_cand=torch.tensor(n_cand, dtype=torch.int64,
                                             device=dev),
                         m=ctx.fed.m, candidates=n_cand)

    def aggregate(self, state: FomoState, stacked, prev, ctx):
        # every client's candidates: the whole stack, gathered
        wmat, keep = fomo_weights(ctx.loss_fn, *ctx.gather((stacked, prev)),
                                  state.x_val, state.y_val, state.n_cand)
        return (_add_residual(ctx.mix(stacked, wmat), prev, ctx.rows(keep)),
                state)

    def traced_state(self, state: FomoState):
        # the validation sets the weighting evaluates on, and the top-M
        # count as a device scalar
        return (state.x_val, state.y_val, state.n_cand)

    def aggregate_traced(self, arrays, stacked, prev, tmix):
        x_val, y_val, n_cand = arrays
        wmat, keep = fomo_weights(self._loss_fn,
                                  *tmix.gather((stacked, prev)), x_val,
                                  y_val, n_cand)
        return _add_residual(tmix.mix(stacked, wmat), prev, tmix.rows(keep))

    def comm(self, state: FomoState) -> CommCost:
        return CommCost(0, state.m * state.candidates)

    @classmethod
    def downlink_cost(cls, m, *, n_streams=1, fomo_candidates=5):
        return CommCost(0, m * fomo_candidates)
