"""Buffered-asynchronous federated round engine.

Counterpart of `repro/fl/runtime/engine.py` (`AsyncConfig`, `run_async`),
followed line for line, its hierarchy branch included; ``paging=``
delegates to `repro_torch.fl.population.run_async_paged`.

The synchronous engine makes every round wait for the slowest of m
shifted-exponential stragglers.  This runtime replaces that barrier
with an event-driven loop over a `VirtualClock`: every client trains
continuously and uploads when its sampled compute finishes; the server
buffers arrivals and fires one aggregation EVENT whenever
`AsyncConfig.buffer_k` uploads are queued (FedBuff-style).  At each
event

  * buffered updates older than ``max_staleness`` server versions are
    dropped (their clients still re-download and restart);
  * only the fresh cohort's local update lands (`Placement.
    update_cohort`; on `HostVmap` a gather of the k rows, the update on
    (k, ...) tensors and a scatter back), value faults and the uplink
    channel touch only those rows;
  * the strategy aggregates unmodified: ``ctx.participation`` masks the
    fresh cohort and ``ctx.staleness`` carries every contributor's model
    age, which `RoundContext.mix` / `mix_plan` route through
    `Strategy.reweight` (on the card the reweighted W goes through the
    Y = W Θ kernel);
  * only the buffered clients download the new mix, so the event is
    charged only the cohort's downlink (at most K broadcast streams and
    the cohort's share of per-client unicasts);
  * `History.time` records the virtual clock (arrival of the K-th
    upload plus the downlink), replacing the analytic max.

``hierarchy=`` nests an edge sub-round inside every upload: the update
step is the fleet update (`repro_torch.fl.hierarchy`), each arrival's
clock draw carries its user's edge sub-round time (``schedule(extra=)``)
and each event books its buffered users' device bits
(`EdgeMeter.charge_event`).  Under static straggler dropping the fleet
update bakes a per-user mask, so partial events take the base
full-width `Placement.update_cohort`.

The random draws come from the run's ``draws`` object, the event index
standing for the round: the update step's ``draw(draws, event, ...)``,
the batch slots of all m clients (the cohort's rows are gathered), and
for a fleet update its edge noise and dropout coins of the rows the
update sees (from the cohort's first user when the cohort is gathered);
then ``fault_draws`` and ``codec_noise`` as the synchronous engine takes
them.  The clock draws from its own numpy stream, as in the reference,
so arrival orders and times are the reference's bit for bit.

Equivalence anchor: with ``inv_mu=0``, ``buffer_k=m`` and unbounded
staleness every event is a lockstep full-participation round, the
synchronous engine's update step and aggregation, bit for bit.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.channel import (Channel, ChannelCost, resolve_channel,
                                    round_downlink_time)
from repro_torch.fl.comm import SYSTEMS, SystemModel
from repro_torch.fl.draws import TorchDraws, round_fault_draws
from repro_torch.fl.faults import (FaultMeter, get_robust_aggregator,
                                   inject_values, pop_with_retries,
                                   resolve_faults, screen_and_defend)
from repro_torch.fl.hierarchy import EdgeMeter, resolve_hierarchy
from repro_torch.fl.placement import Placement, resolve_placement
from repro_torch.fl.runtime.clock import VirtualClock
from repro_torch.fl.simulator import (FLConfig, History, channel_extra,
                                      channel_uplink, finalize_history,
                                      init_channel, init_run,
                                      per_client_uplink_bits, record_eval,
                                      resolve_strategy)
from repro_torch.fl.strategies import CommCost, Strategy
from repro_torch.models import lenet


@dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the buffered-asynchronous server.

    buffer_k:           aggregation fires when this many client uploads are
                        buffered (clamped to m; K=m with a reliable system
                        degenerates to the synchronous engine).
    max_staleness:      drop buffered updates whose base model is older than
                        this many server versions (None = keep everything).
    staleness_schedule: contributor-discount law routed through
                        `Strategy.reweight`: ``"exp"`` (FedBuff-style
                        ``λ**age``) or ``"poly"`` (FedAsync's
                        ``(1+age)**-α``, Xie et al. 2019).
    staleness_discount: λ of the ``exp`` schedule (1.0 = no discounting).
    staleness_alpha:    α of the ``poly`` schedule.
    max_retries:        with a crash fault model: a client whose upload
                        crashes this many CONSECUTIVE times is dead for
                        the run (0 = first crash kills).
    retry_backoff:      base of the crashed-arrival reschedule delay,
                        ``backoff · 2**attempt`` (deterministic
                        exponential backoff; no new compute draw).
    """
    buffer_k: int = 2
    max_staleness: Optional[float] = None
    staleness_schedule: str = "exp"
    staleness_discount: float = 0.9
    staleness_alpha: float = 0.5
    max_retries: int = 3
    retry_backoff: float = 1.0

    def __post_init__(self):
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.retry_backoff <= 0.0:
            raise ValueError(f"retry_backoff must be > 0, got "
                             f"{self.retry_backoff}")
        if self.staleness_schedule not in ("exp", "poly"):
            raise ValueError("staleness_schedule must be 'exp' or 'poly', "
                             f"got {self.staleness_schedule!r}")
        if not 0.0 < self.staleness_discount <= 1.0:
            raise ValueError("staleness_discount must be in (0, 1], got "
                             f"{self.staleness_discount}")
        if self.staleness_alpha < 0.0:
            raise ValueError("staleness_alpha must be >= 0, got "
                             f"{self.staleness_alpha}")
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 or None, got "
                             f"{self.max_staleness}")


def run_async(algorithm: Union[str, Strategy, None] = None,
              fed: Optional[FederatedData] = None, *,
              strategy: Optional[Strategy] = None,
              async_cfg: Optional[AsyncConfig] = None,
              fl: Optional[FLConfig] = None,
              model_init: Optional[Callable] = None,
              loss_fn: Callable = lenet.loss_fn,
              acc_fn: Callable = lenet.accuracy,
              system: Optional[SystemModel] = None,
              placement: Optional[Placement] = None,
              channel: Union[str, Channel, None] = None,
              keep_state: bool = False,
              paging: Optional[Any] = None,
              hierarchy: Optional[Any] = None,
              faults: Optional[Any] = None,
              robust_agg: Optional[Any] = None,
              min_quorum: Optional[int] = None,
              seed: int = 0,
              draws: Optional[Any] = None,
              device: DeviceLike = "cuda") -> History:
    """Run `fl.rounds` buffered-async aggregation events; returns History.

    Same surface as `run_federated` (which delegates here when passed
    ``async_cfg=``), minus ``sampler`` and ``superstep``: the arrival
    buffer is the per-event cohort, and events run unfused.  ``system``
    drives the virtual clock (default: the reliable ``wired`` model, i.e.
    deterministic lockstep arrivals); ``channel`` adds uplink compression,
    bit accounting and per-client link timing; ``faults``, ``robust_agg``
    and ``min_quorum`` as in `run_federated`, a crash deciding at the
    clock (`pop_with_retries`).  ``History.extra["async"]`` records the
    configuration.  ``paging`` (a `PagingConfig`) runs the store-backed
    engine (`run_async_paged`: the arrival buffer is the page request,
    ``fed`` may live on the host; `TypeError` beside ``hierarchy``).
    ``hierarchy`` nests an edge sub-round inside every client upload:
    device uploads buffer at the user's edge, the user's pseudo-update is
    what arrives at the server, and each arrival's clock draw carries the
    user's edge sub-round time as a fixed ``extra`` term.
    """
    if paging is not None:
        if hierarchy is not None:
            raise TypeError("the hierarchy tier does not compose with the "
                            "cohort paging engine yet (the store pages "
                            "flat client rows, not device fleets)")
        from repro_torch.fl.population import run_async_paged
        return run_async_paged(algorithm, fed, paging=paging,
                               strategy=strategy, async_cfg=async_cfg, fl=fl,
                               model_init=model_init, loss_fn=loss_fn,
                               acc_fn=acc_fn, system=system,
                               placement=placement, channel=channel,
                               keep_state=keep_state, faults=faults,
                               robust_agg=robust_agg, min_quorum=min_quorum,
                               seed=seed, draws=draws, device=device)
    if hierarchy is not None:
        hierarchy = resolve_hierarchy(hierarchy)
    faults = resolve_faults(faults)
    dev = resolve_device(device)
    strategy = resolve_strategy(algorithm, strategy)
    if fed is None:
        raise TypeError("`fed` is required")
    if fed.x.device != dev:
        raise ValueError(f"fed lives on {fed.x.device}, run asked for "
                         f"device={str(device)!r}")
    cfg = AsyncConfig() if async_cfg is None else async_cfg
    fl = FLConfig() if fl is None else fl
    system = SYSTEMS["wired"] if system is None else system
    placement = resolve_placement(placement)
    channel = resolve_channel(channel)
    codec = channel.codec if channel is not None else None
    lossy = codec is not None and not codec.is_identity
    draws = TorchDraws(seed, dev) if draws is None else draws

    m = fed.m
    if not placement.holds_clients(m):
        # a mesh rank beyond the client axis: rank 0's History
        return placement.share(None)
    k_buf = min(cfg.buffer_k, m)
    tau = np.inf if cfg.max_staleness is None else float(cfg.max_staleness)

    # the sync engine's init path (the lockstep anchor); the update is
    # functional, so `prev` stays intact for every event's rollbacks
    update_fn, stacked, opt_state, data, ctx, state = init_run(
        strategy, fed, fl, model_init, loss_fn, acc_fn, placement, seed,
        draws, dev, faults=faults, hierarchy=hierarchy, system=system)
    x, _, n = data
    n = placement.gather(n)     # the draws' counts: every client's
    rows = placement.rows
    hplan = ctx.hierarchy_plan
    meter = None if hplan is None else EdgeMeter(hplan)
    # the fleet step bakes a static per-user straggler mask: row gathers
    # would misalign it, so partial events take the base full-width path,
    # which is also the cohort update of a placement that does not
    # override it (the mesh: every row runs, the cohort's rows masked in)
    cohort = type(placement).update_cohort
    full_width = ((hplan is not None and not hplan.row_local)
                  or cohort is Placement.update_cohort)
    if full_width:
        cohort = Placement.update_cohort
    plan = ctx.fault_plan
    defense = get_robust_aggregator(robust_agg)
    robust_spec = "none" if defense is None else str(robust_agg)
    byz_row = (None if plan is None
               else torch.from_numpy(plan.byz_row()).to(dev))
    fmeter = None
    if plan is not None or defense is not None or min_quorum is not None:
        fmeter = FaultMeter(plan, robust_spec, min_quorum)
    attempts: dict = {}         # per-client consecutive-crash counter
    ctx.staleness_discount = cfg.staleness_discount
    ctx.staleness_schedule = cfg.staleness_schedule
    ctx.staleness_alpha = cfg.staleness_alpha

    payload, link, model_bits, ef, channel = init_channel(
        channel, ctx, stacked, system, m)
    ul_bits_pc = per_client_uplink_bits(channel, ctx, payload, m)
    d = sum(leaf[0].numel() for leaf in stacked.values())

    def _ul_bits(c: int):
        return payload if ul_bits_pc is None else int(ul_bits_pc[c])

    # the clock's draws come from its own numpy stream; the link profile
    # (if any) swaps the homogeneous ρ uplink for each client's own
    clock = VirtualClock(system, seed=seed, link=link)

    def _edge_time(c: int) -> float:
        # the device fleet's sub-round runs before the user's own compute
        # begins; 0.0 without a hierarchy, which is exact in the clock
        return meter.time_of(c) if meter is not None else 0.0

    for i in range(m):
        clock.schedule(i, 0.0, ul_bits=_ul_bits(i), extra=_edge_time(i))
    # server version at each client's last model download; a model's age
    # at event e is  e - version[i]
    version = np.zeros(m, dtype=np.int64)

    history = History()
    t_done = 0.0

    for event in range(fl.rounds):
        # with a crash fault model, arrivals survive a crash coin: crashed
        # ones requeue with exponential backoff (no new compute draw),
        # capped retries kill the client
        buffered = []
        while len(buffered) < k_buf:
            nxt = pop_with_retries(clock, plan, cfg.max_retries,
                                   cfg.retry_backoff, attempts, fmeter)
            if nxt is None:
                break
            buffered.append(nxt[1])
        if not buffered:
            warnings.warn(
                f"async run ended early at event {event}/{fl.rounds}: "
                "every remaining client exhausted its crash retries "
                f"(dead: {sorted(fmeter.dead) if fmeter else []})",
                RuntimeWarning, stacklevel=2)
            break
        age = event - version                       # (m,) contributor ages
        fresh_np = np.zeros(m, dtype=bool)
        fresh_np[[c for c in buffered if age[c] <= tau]] = True
        all_fresh = bool(fresh_np.all())

        # a fleet update's edge draws are those of the rows the update
        # sees: the gathered cohort's, from its first user, or every row's
        gathered = not all_fresh and not full_width
        batch_idx = update_fn.draw(
            draws, event, x, n, row=buffered[0] if gathered else 0,
            rows=len(buffered) if gathered else None)
        prev, prev_opt = stacked, opt_state
        if all_fresh:
            # lockstep event (K=m, nothing stale): the sync engine's step
            mask = None
            stacked, opt_state = update_fn(stacked, opt_state, *data,
                                           rows(batch_idx))
        else:
            # only the fresh cohort's local work lands; in-flight clients
            # and stale-dropped updates stay at their server-known models
            mask = torch.from_numpy(fresh_np).to(dev)
            stacked, opt_state = cohort(
                placement, update_fn,
                torch.tensor(buffered, dtype=torch.int64, device=dev),
                torch.from_numpy(fresh_np[buffered]).to(dev), stacked,
                opt_state, *data, batch_idx)

        if plan is not None and plan.value_faults:
            # the fresh cohort's TRANSMITTED updates are corrupted (arrival
            # crashes were already decided at the clock)
            fd = round_fault_draws(draws, event, m, d, plan.cfg, dev)
            stacked = inject_values(plan, rows(byz_row), stacked, prev,
                                    rows(fd), rows=rows(mask))

        if lossy:
            # the fresh cohort's updates cross the codec; in-flight and
            # stale-dropped rows (mask False) transmit nothing and keep
            # their error-feedback residuals
            stacked, ef = channel_uplink(placement, channel, stacked, prev,
                                         ef, draws, event, rows(mask), m)

        q = None
        if defense is not None:
            # screening + robust aggregation before mixing
            stacked, q = screen_and_defend(defense, stacked, prev,
                                           placement)

        n_fresh = int(fresh_np.sum())
        quorum_ok = min_quorum is None or n_fresh >= min_quorum
        if quorum_ok:
            ctx.rnd, ctx.participation = event, mask
            ctx.staleness = (torch.from_numpy(age.astype(np.float32)).to(dev)
                             if age.any() else None)
            ctx.quarantine = q
            mixed, state = strategy.aggregate(state, stacked, prev, ctx)
            ctx.quarantine = None

            # the buffered clients (fresh AND stale-dropped) pull the new
            # mix and restart; everyone else is mid-flight, keeps its model
            down_np = np.zeros(m, dtype=bool)
            down_np[buffered] = True
            if down_np.all():
                stacked = mixed
            else:
                stacked = placement.select(
                    rows(torch.from_numpy(down_np).to(dev)), mixed, stacked)
        else:
            # below quorum: the event is undone (no mix, no downlink, no
            # version bump); the buffered clients restart from their last
            # downloaded models and their uploads are wasted (the EF
            # residuals keep the uplink they actually transmitted)
            stacked, opt_state = prev, prev_opt

        # event-level downlink: only the buffered cohort downloads, so the
        # server transmits at most k_buf broadcast streams and the cohort's
        # share of any per-client unicasts (K=m recovers the full cost)
        ul_total = (sum(_ul_bits(c) for c in buffered)
                    if channel is not None else 0)
        if quorum_ok:
            cost = strategy.comm(state)
            cost = CommCost(min(cost.n_streams, len(buffered)),
                            int(round(cost.n_unicasts * len(buffered) / m)))
        else:
            cost = CommCost(0, 0)       # no mix moved: no downlink at all
        history.comm.append(cost)
        if channel is not None:
            # every buffered client uploaded one payload (stale-dropped
            # uploads still crossed the channel); the cohort downloads the
            # codec-compressed model per stream
            history.comm_bits.append(ChannelCost(
                dl_bits=(cost.n_streams + cost.n_unicasts) * payload,
                ul_bits=ul_total))
        if meter is not None:
            # the device→user hop's bits of this event's arrivals (their
            # edge time is already in each arrival's clock draw)
            meter.charge_event(buffered)
        if quorum_ok:
            if link is not None:
                # the sync clock's charging rule over the buffered cohort,
                # membership-aware when the strategy has a stream map
                duration = round_downlink_time(link, cost, payload, buffered,
                                               strategy.membership(state))
            else:
                duration = cost.n_streams + cost.n_unicasts
            # this event's streams run concurrently with any broadcast still
            # in flight from an earlier one: a no-op in lockstep
            done = clock.serve(duration, overlap=True)
        else:
            done = clock.now            # nothing served; time still passed
        # the reported clock stays monotone even if a later event's shorter
        # broadcast completes before an earlier long one
        t_done = max(t_done, done)
        for c in buffered:
            clock.schedule(c, done, ul_bits=_ul_bits(c),
                           extra=_edge_time(c))
            if quorum_ok:
                version[c] = event + 1
        if fmeter is not None:
            qrow = None if q is None else q.cpu().numpy()
            qbits = 0
            if channel is not None and qrow is not None and quorum_ok:
                qbits = int(np.sum(qrow <= 0)) * payload
            fmeter.charge(None, qrow, quorum_ok,
                          ul_total if channel is not None else 0, qbits)

        if event % fl.eval_every == 0 or event == fl.rounds - 1:
            mean_acc, worst_acc = placement.evaluate(acc_fn, stacked, fed)
            record_eval(history, event, mean_acc, worst_acc, t_done)

    if keep_state:
        stacked, opt_state, ef = placement.gather((stacked, opt_state, ef))
    history = finalize_history(history, strategy, state, keep_state,
                               stacked, opt_state)
    history.extra["async"] = {"buffer_k": k_buf,
                              "max_staleness": cfg.max_staleness,
                              "staleness_schedule": cfg.staleness_schedule,
                              "staleness_discount": cfg.staleness_discount,
                              "staleness_alpha": cfg.staleness_alpha,
                              "max_retries": cfg.max_retries,
                              "retry_backoff": cfg.retry_backoff,
                              "events": fl.rounds}
    if meter is not None:
        history.extra["hierarchy"] = meter.extra()
    if fmeter is not None:
        history.extra["faults"] = fmeter.extra()
    if channel is not None:
        channel_extra(history, channel, link, model_bits, payload)
        if keep_state:
            history.final_residual = ef
    return placement.share(history)
