"""Federated learning round engine: the eventful per-round loop.

Counterpart of the eventful half of `repro/fl/simulator.py`
(`run_federated` with ``superstep=False``, which the reference pins as
bit-identical to its fused default).  The engine owns the local update,
evaluation and the analytic clock; the `Strategy` owns aggregation and the
`Placement` the layout:

    run_federated("ucfl_k4", fed, fl=FLConfig(rounds=20),
                  system=SYSTEMS["wireless_slow"])

Every round: draw the minibatch slots, run every client's local SGD,
let the strategy mix (Y = W Θ on the card, one kernel launch per leaf),
charge the round on the clock, evaluate every ``eval_every`` rounds.

The reference's JAX key chain is replaced by a ``draws`` object
(`repro_torch.fl.draws`); the default draws from `torch.Generator`s.
Options that belong to later slices of the port (samplers, channel,
faults, hierarchy, async, paging, the fused superstep) raise
`NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.comm import SystemModel
from repro_torch.fl.draws import TorchDraws, init_generator
from repro_torch.fl.placement import Placement, resolve_placement
from repro_torch.fl.strategies import (CommCost, RoundContext, Strategy,
                                       StrategyExtras, get_strategy)
from repro_torch.models import lenet


@dataclass
class FLConfig:
    local_steps: int = 10
    batch_size: int = 64
    lr: float = 0.1
    momentum: float = 0.9
    # optimizer-state dtype policy: None = fp32 state, "param" = momentum
    # kept in the param dtype
    opt_state_dtype: Optional[str] = None
    rounds: int = 60
    sigma_batches: int = 5
    eval_every: int = 5


@dataclass
class History:
    rounds: List[int] = field(default_factory=list)
    mean_acc: List[float] = field(default_factory=list)
    worst_acc: List[float] = field(default_factory=list)
    time: List[float] = field(default_factory=list)
    comm: List[CommCost] = field(default_factory=list)
    extras: Optional[StrategyExtras] = None
    # legacy mapping view, filled by the engine from `comm` + `extras`
    extra: Dict[str, Any] = field(default_factory=dict)
    # populated when run_federated(keep_state=True): the final client-
    # stacked params / optimizer state (still on the device)
    final_params: Any = None
    final_opt_state: Any = None


class NonFiniteEvalWarning(RuntimeWarning):
    """A recorded eval score was NaN/Inf — the run diverged."""


# What each option waits for, by its item in ROADMAP.md's Queue 1.
_LATER = {
    "sampler": "item 5 (client samplers, with local/oracle)",
    "channel": "item 6 (channel)",
    "superstep": "item 8 (superstep)",
    "async_cfg": "item 9 (async runtime)",
    "paging": "item 12 (paging)",
    "hierarchy": "item 13 (hierarchy)",
    "faults": "item 14 (faults)",
    "robust_agg": "item 14 (faults)",
    "min_quorum": "item 14 (faults)",
}


def default_model_init(fed: FederatedData) -> Callable:
    """LeNet sized to the scenario's images; called with a generator."""
    in_size, channels = fed.x.shape[2], fed.x.shape[4]
    n_classes = int(fed.y.max()) + 1
    cfg = lenet.LeNetConfig(in_size=in_size, in_channels=channels,
                            n_classes=max(n_classes, 10))
    return lambda gen: lenet.init_params(gen, cfg, device=gen.device)


def resolve_strategy(algorithm: Union[str, Strategy, None],
                     strategy: Optional[Strategy]) -> Strategy:
    """spec-string-or-instance -> Strategy."""
    if strategy is not None:
        if algorithm is not None:
            raise TypeError("pass either `algorithm` or `strategy=`, not both")
        return strategy
    if algorithm is None:
        raise TypeError("one of `algorithm` or `strategy=` is required")
    if isinstance(algorithm, Strategy):
        return algorithm
    return get_strategy(algorithm)


def init_run(strategy: Strategy, fed: FederatedData, fl: FLConfig,
             model_init: Optional[Callable], loss_fn: Callable,
             acc_fn: Callable, placement: Placement, seed: int, draws: Any,
             device):
    """Run prologue: model init, update step, client stack/opt/data
    placement, RoundContext and `strategy.setup`.  Returns
    ``(update_fn, stacked, opt_state, data, ctx, state)``."""
    if model_init is None:
        model_init = default_model_init(fed)
    params0 = model_init(init_generator(seed, device))
    opt, update_fn = placement.build_update(loss_fn, fl)
    stacked = placement.stack(params0, fed.m)
    opt_state = placement.init_opt(opt, stacked)
    data = placement.place_data(fed)
    ctx = RoundContext(fed=fed, fl=fl, loss_fn=loss_fn, acc_fn=acc_fn,
                       params0=params0, seed=seed, draws=draws,
                       placement=placement)
    state = strategy.setup(ctx)
    return update_fn, stacked, opt_state, data, ctx, state


def charge_round(history: History, cost: CommCost, m: int,
                 system: Optional[SystemModel], t_accum: float) -> float:
    """One round's comm and clock accounting (system clock only: every
    client participates); returns the updated clock."""
    history.comm.append(cost)
    if system is not None:
        t_accum += system.round_time(m, n_streams=cost.n_streams,
                                     n_unicasts=cost.n_unicasts)
    return t_accum


def record_eval(history: History, rnd: int, mean_acc: float,
                worst_acc: float, t_accum: float) -> None:
    """Append one eval row; a NaN/Inf accuracy warns `NonFiniteEvalWarning`
    and is booked under ``History.extra["nonfinite_evals"]``."""
    if not (np.isfinite(mean_acc) and np.isfinite(worst_acc)):
        warnings.warn(
            f"non-finite eval at round {rnd}: mean_acc={mean_acc}, "
            f"worst_acc={worst_acc} — the run diverged",
            NonFiniteEvalWarning, stacklevel=2)
        history.extra["nonfinite_evals"] = (
            history.extra.get("nonfinite_evals", 0) + 1)
    history.rounds.append(rnd)
    history.mean_acc.append(mean_acc)
    history.worst_acc.append(worst_acc)
    history.time.append(t_accum)


def finalize_history(history: History, strategy: Strategy, state: Any,
                     keep_state: bool, stacked: Any, opt_state: Any
                     ) -> History:
    """Run epilogue: typed extras, the legacy extra dict, and the optional
    final device-resident state."""
    history.extras = strategy.extras(state)
    history.extra["comm_per_round"] = list(history.comm)
    if history.extras is not None:
        history.extra.update(dataclasses.asdict(history.extras))
    if keep_state:
        history.final_params, history.final_opt_state = stacked, opt_state
    return history


def run_federated(algorithm: Union[str, Strategy, None] = None,
                  fed: Optional[FederatedData] = None, *,
                  strategy: Optional[Strategy] = None,
                  sampler: Optional[Any] = None,
                  fl: Optional[FLConfig] = None,
                  model_init: Optional[Callable] = None,
                  loss_fn: Callable = lenet.loss_fn,
                  acc_fn: Callable = lenet.accuracy,
                  system: Optional[SystemModel] = None,
                  placement: Optional[Placement] = None,
                  channel: Optional[Any] = None,
                  keep_state: bool = False,
                  async_cfg: Optional[Any] = None,
                  superstep: Optional[bool] = None,
                  paging: Optional[Any] = None,
                  hierarchy: Optional[Any] = None,
                  faults: Optional[Any] = None,
                  robust_agg: Optional[str] = None,
                  min_quorum: Optional[int] = None,
                  seed: int = 0,
                  draws: Optional[Any] = None,
                  device: DeviceLike = "cuda") -> History:
    """Run one strategy on one scenario; returns the accuracy/time history.

    ``algorithm`` is a registry spec (``"fedavg"``, ``"ucfl"``,
    ``"ucfl_k4"``) or a `Strategy`; alternatively pass ``strategy=``.
    ``fed`` must live on ``device``.  ``model_init`` is called with a
    `torch.Generator` on ``device`` and returns the param dict (default:
    LeNet-5 sized to the scenario).  ``draws`` supplies the run's random
    draws (default `TorchDraws(seed, device)`).  ``keep_state=True``
    attaches the final stacked params / opt state to the History.
    ``superstep`` None or False runs this eventful loop; True raises, as
    do the options of later slices.
    """
    later = dict(sampler=sampler, channel=channel, async_cfg=async_cfg,
                 paging=paging, hierarchy=hierarchy, faults=faults,
                 robust_agg=robust_agg, min_quorum=min_quorum,
                 superstep=superstep or None)
    for name, value in later.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet: ROADMAP.md Queue 1 "
                f"{_LATER[name]}")
    dev = resolve_device(device)
    strategy = resolve_strategy(algorithm, strategy)
    if fed is None:
        raise TypeError("`fed` is required")
    if fed.x.device != dev:
        raise ValueError(f"fed lives on {fed.x.device}, run asked for "
                         f"device={str(device)!r}")
    fl = FLConfig() if fl is None else fl
    placement = resolve_placement(placement)
    draws = TorchDraws(seed, dev) if draws is None else draws
    update_fn, stacked, opt_state, (x, y, n), ctx, state = init_run(
        strategy, fed, fl, model_init, loss_fn, acc_fn, placement, seed,
        draws, dev)

    history = History()
    t_accum = 0.0
    for rnd in range(fl.rounds):
        idx = draws.batch_indices(rnd, n, x.shape[1], fl.batch_size,
                                  fl.local_steps)
        prev = stacked        # the update is functional: prev stays intact
        stacked, opt_state = update_fn(stacked, opt_state, x, y,
                                       idx.to(x.device))
        ctx.rnd = rnd
        stacked, state = strategy.aggregate(state, stacked, prev, ctx)
        t_accum = charge_round(history, strategy.comm(state), fed.m, system,
                               t_accum)
        if rnd % fl.eval_every == 0 or rnd == fl.rounds - 1:
            mean_acc, worst_acc = placement.evaluate(acc_fn, stacked, fed)
            record_eval(history, rnd, mean_acc, worst_acc, t_accum)

    return finalize_history(history, strategy, state, keep_state, stacked,
                            opt_state)
