"""Federated learning round engine: the fused superstep and the eventful
per-round loop.

Counterpart of `repro/fl/simulator.py` (`run_federated` with its fused
superstep default and ``superstep=False``'s eventful loop, which the
reference pins as bit-identical), with its fault, defense and quorum
branches and its hierarchy branch.  The engine owns the local update,
client sampling, fault injection, the uplink channel, the defense
layer, evaluation and the analytic clock; the `Strategy` owns
aggregation and the `Placement` the layout:

    run_federated("ucfl_k4", fed, fl=FLConfig(rounds=20),
                  sampler=UniformFraction(0.5),
                  channel=Channel(codec="qsgd:8", link="tiered:4"),
                  system=SYSTEMS["wireless_slow"])

Every round: draw the minibatch slots, run every client's local SGD,
roll the non-participants of the sampler's mask back to their pre-round
model and optimizer state, inject the round's faults (``faults=``:
Byzantine, bit-rot and NaN corrupt what a client transmits, a crash
rolls its row back like a no-show), pass the participants' update
v = Δ + e through the channel codec with error feedback (on the card:
the QSGD or top-k kernels), screen and robustify the decoded updates
(``robust_agg=``; quarantined clients' weight columns renormalized
away), let the strategy mix (Y = W Θ on the card, one kernel launch a
round) unless fewer than ``min_quorum`` clients took part, charge the
round on the clock (through the link profile when a channel is
attached), in `History.comm_bits` and in the fault ledger
(``History.extra["faults"]``), and evaluate every ``eval_every``
rounds.  ``hierarchy=`` (`repro_torch.fl.hierarchy`) nests an edge
sub-round inside the local update: the update step becomes the fleet
update (per-device local SGD, the edge codec with error feedback over
the (m·d_max, F) device rows, the edge aggregator's combine), the
optimizer-state slot carries the `EdgeState`, and the `EdgeMeter`
charges the device→user hop on the clock and in
``History.extra["hierarchy"]``.

By default (``superstep=None``) a run whose strategy and sampler are
traceable (`superstep_support`) is fused: the rounds between two eval
boundaries (`_eval_rounds`) and the eval ending them run as one chunk
(`Placement.run_supersteps`), on the card one captured CUDA graph
replayed with nothing enqueued by the host in between, on the CPU the
same round function run eagerly.  The chunk's draws are taken before it
runs, in the eventful order (`fl.draws.chunk_draws`); the clock and the
comm accounting are replayed on the host after it, in the eventful
order; so the fused run's history and final params are bitwise the
eventful run's.  ``superstep=False`` forces the eventful loop, and True
raises `ValueError` when the run cannot fuse.

``async_cfg=`` (an `AsyncConfig`) delegates to the buffered-async event
loop (`repro_torch.fl.runtime.run_async`), which takes no sampler and
never fuses.  ``paging=`` (a `PagingConfig`) delegates to the cohort
paging engine (`repro_torch.fl.population.run_paged`), which runs this
module's fused superstep one cohort at a time.

The reference's JAX key chain is replaced by a ``draws`` object
(`repro_torch.fl.draws`); the default draws from `torch.Generator`s.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

import torch

from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.channel import (Channel, ChannelCost, resolve_channel,
                                    round_downlink_time, tree_bits,
                                    zeros_like_stack)
from repro_torch.fl.comm import SYSTEMS, SystemModel
from repro_torch.fl.draws import (TorchDraws, chunk_draws, init_generator,
                                  round_fault_draws)
from repro_torch.fl.faults import (FaultMeter, crash_mask,
                                   get_robust_aggregator, inject_values,
                                   resolve_fault_plan, resolve_faults,
                                   screen_and_defend)
from repro_torch.fl.hierarchy import (EdgeMeter, init_fleet_run,
                                      resolve_hierarchy)
from repro_torch.fl.placement import (Placement, resolve_placement,
                                      score_stats)
from repro_torch.fl.placement.graphs import tree_map
from repro_torch.fl.strategies import (ClientSampler, CommCost, RoundContext,
                                       Strategy, StrategyExtras, TracedMix,
                                       get_strategy)
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
    fomo_candidates: int = 5
    cfl_eps1: float = 0.04
    cfl_eps2: float = 0.06
    cfl_min_rounds: int = 10


@dataclass
class History:
    rounds: List[int] = field(default_factory=list)
    mean_acc: List[float] = field(default_factory=list)
    worst_acc: List[float] = field(default_factory=list)
    time: List[float] = field(default_factory=list)
    comm: List[CommCost] = field(default_factory=list)
    # bits-based sibling of `comm`, one entry per round — populated only
    # when the run carries a Channel
    comm_bits: List[ChannelCost] = field(default_factory=list)
    extras: Optional[StrategyExtras] = None
    # legacy mapping view, filled by the engine from `comm` + `extras`
    extra: Dict[str, Any] = field(default_factory=dict)
    # populated when run_federated(keep_state=True): the final client-
    # stacked params / optimizer state (still on the device), and the
    # error-feedback residual stack of a lossy channel
    final_params: Any = None
    final_opt_state: Any = None
    final_residual: Any = None


class NonFiniteEvalWarning(RuntimeWarning):
    """A recorded eval score was NaN/Inf — the run diverged."""


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
             device, faults: Optional[Any] = None,
             hierarchy: Optional[Any] = None,
             system: Optional[SystemModel] = None):
    """Run prologue of the sync and async engines: model init, update
    step, client stack/opt/data placement, RoundContext and
    `strategy.setup`.  Returns
    ``(update_fn, stacked, opt_state, data, ctx, state)``.  ``faults`` (a
    `FaultConfig`) is resolved once here into the run's `FaultPlan`
    (static Byzantine set), on ``ctx.fault_plan`` (None: no faults).

    With ``hierarchy`` (a resolved `HierarchyConfig`) the update step is
    the fleet update (`FleetUpdate`), the data grows the nested device
    axis, the optimizer-state slot carries the `EdgeState`, and the
    resolved `FleetPlan` rides on ``ctx.hierarchy_plan`` (None: flat) for
    the engines' `EdgeMeter`.  ``system`` is read only there (the edge
    link resolves against it, as `init_channel`'s link does)."""
    if model_init is None:
        model_init = default_model_init(fed)
    params0 = model_init(init_generator(seed, device))
    if hierarchy is None:
        opt, update_fn = placement.build_update(loss_fn, fl)
        stacked = placement.stack(params0, fed.m)
        opt_state = placement.init_opt(opt, stacked)
        data = placement.place_data(fed)
        plan = None
    else:
        update_fn, stacked, opt_state, data, plan = init_fleet_run(
            hierarchy, placement, loss_fn, fl, fed, params0, system=system,
            strategy=strategy)
    ctx = RoundContext(fed=fed, fl=fl, loss_fn=loss_fn, acc_fn=acc_fn,
                       params0=params0, seed=seed, draws=draws,
                       placement=placement, strategy=strategy)
    ctx.hierarchy_plan = plan
    ctx.fault_plan = resolve_fault_plan(faults, fed.m)
    state = strategy.setup(ctx)
    return update_fn, stacked, opt_state, data, ctx, state


def init_channel(channel: Optional[Channel], ctx: RoundContext,
                 stacked: Any, system: Optional[SystemModel], m: int):
    """Channel prologue: payload bits, resolved link profile and the
    error-feedback residual stack.  Returns ``(payload, link, model_bits,
    ef, channel)``, all None/0 without a channel.  The link is resolved
    first (against the wired model when no ``system`` consumes it, so
    ``extra["channel"]`` records it), then the codec is bound to it: rate-
    adaptive codecs pick their per-client parameters here, so callers use
    the RETURNED channel from this point on."""
    if channel is None:
        return None, None, 0, None, None
    model_bits = tree_bits(ctx.params0)
    link = channel.resolve_link(system if system is not None
                                else SYSTEMS["wired"], model_bits, m)
    codec = channel.codec.bind_link(link, ctx.params0)
    if codec is not channel.codec:
        channel = dataclasses.replace(channel, codec=codec)
    ef = None if codec.is_identity else zeros_like_stack(stacked)
    payload = codec.payload_bits(ctx.params0)
    return payload, link, model_bits, ef, channel


def per_client_uplink_bits(channel: Optional[Channel], ctx: RoundContext,
                           payload: Optional[int],
                           m: int) -> Optional[np.ndarray]:
    """(m,) per-client uplink payload vector when the bound codec's bits
    are NOT uniform (rate-adaptive codecs), else None — keeping the fixed-
    codec accounting on its exact scalar path."""
    if channel is None:
        return None
    vec = channel.codec.per_client_bits(ctx.params0, m)
    return None if np.all(vec == payload) else vec


def channel_uplink(placement: Placement, channel: Channel, stacked: Any,
                   prev: Any, ef: Any, draws: Any, rnd: int,
                   mask: Optional[torch.Tensor], m: int):
    """One round's uplink crossing (lossy codecs only): the codec's noise
    comes from ``draws.codec_noise`` in the flat view's (m, D) layout (the
    reference's ``uniform(fold_in(kround, 2), (m, D))``), drawn for all
    ``m`` clients and cut to the placement's rows (``mask`` is already
    cut); residuals carry forward only with error feedback on."""
    noise = None
    if channel.codec.needs_noise:
        d = sum(leaf[0].numel() for leaf in stacked.values())
        noise = placement.rows(draws.codec_noise(rnd, (m, d)).to(
            next(iter(stacked.values())).device))
    stacked, new_ef = placement.uplink(channel.codec, stacked, prev, ef,
                                       noise, mask)
    return stacked, (new_ef if channel.error_feedback else ef)


def channel_extra(history: History, channel: Channel, link,
                  model_bits: int, ul_payload: int) -> None:
    """`History.extra["channel"]`: codec/link identity, per-payload bits
    and the run's cumulative bit totals."""
    history.extra["channel"] = {
        "codec": channel.codec.spec,
        "error_feedback": bool(channel.error_feedback),
        "link": link.name if link is not None else None,
        "model_bits": int(model_bits),
        "payload_bits": int(ul_payload),
        "dl_bits_total": int(sum(c.dl_bits for c in history.comm_bits)),
        "ul_bits_total": int(sum(c.ul_bits for c in history.comm_bits)),
    }


def charge_round(history: History, cost: CommCost,
                 mask_np: Optional[np.ndarray], m: int, payload: int, link,
                 system: Optional[SystemModel], channel: Optional[Channel],
                 t_accum: float, assignment: Optional[np.ndarray] = None,
                 ul_bits_pc: Optional[np.ndarray] = None,
                 edge: Optional[Any] = None) -> float:
    """One round's comm/bits/clock accounting; returns the updated clock.
    ``mask_np`` is the host-side participation row (None or all-True =
    full cohort), ``assignment`` the strategy's client→stream map
    (membership-aware broadcast charging, None = the cohort-slowest upper
    bound), ``ul_bits_pc`` the (m,) per-client uplink payload vector
    (rate-adaptive codecs; None = ``payload`` per client), ``edge`` the
    hierarchy tier's `EdgeMeter`: the device→user hop's bits land in its
    own books every round, and its time (the slowest participating
    user's edge sub-round) is added to the clock when a ``system`` runs
    one."""
    history.comm.append(cost)
    n_part, participants = m, None
    if channel is not None or system is not None or edge is not None:
        # the round only waits for the clients that computed: H_|S| under
        # partial participation, not H_m
        if mask_np is not None and not mask_np.all():
            n_part = int(mask_np.sum())
            participants = np.where(mask_np)[0]
    if channel is not None:
        # downlink streams move the codec-compressed model
        if ul_bits_pc is None:
            ul_bits = n_part * payload
        else:
            idx = participants if participants is not None else slice(None)
            ul_bits = int(np.sum(ul_bits_pc[idx]))
        history.comm_bits.append(ChannelCost(
            dl_bits=(cost.n_streams + cost.n_unicasts) * payload,
            ul_bits=ul_bits))
    if system is not None:
        if link is not None:
            ul = payload if ul_bits_pc is None else ul_bits_pc
            t_accum += (system.compute_time(n_part)
                        + link.max_uplink_time(ul, participants)
                        + round_downlink_time(link, cost, payload,
                                              participants, assignment))
        else:
            t_accum += system.round_time(n_part, n_streams=cost.n_streams,
                                         n_unicasts=cost.n_unicasts)
    if edge is not None:
        t_edge = edge.charge(mask_np)
        if system is not None:
            t_accum += t_edge
    return t_accum


def charge_faults(fmeter: FaultMeter, crow: Optional[np.ndarray],
                  qrow: Optional[np.ndarray], eff: Optional[np.ndarray],
                  n_eff: int, ok: bool, channel: Optional[Channel],
                  payload: Optional[int],
                  ul_bits_pc: Optional[np.ndarray]) -> None:
    """Book one round in the fault ledger: ``crow`` the host crash row
    (None: no crash axis), ``qrow`` the quarantine survival row (None: no
    defense), ``eff`` the participation row after crashes (None: all), of
    ``n_eff`` clients, ``ok`` whether the quorum held.  With a channel the
    round's uplink bits are wasted when the quorum fails, the quarantined
    rows' share when it holds."""
    rbits = qbits = 0
    if channel is not None:
        rbits = (n_eff * payload if ul_bits_pc is None else
                 int(np.sum(ul_bits_pc[eff]) if eff is not None
                     else np.sum(ul_bits_pc)))
        if qrow is not None:
            qbits = int(np.sum(qrow <= 0)) * payload
    fmeter.charge(crow, qrow, ok, rbits, qbits)


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
    final device-resident state (every client's rows: the caller gathers
    a mesh rank's)."""
    history.extras = strategy.extras(state)
    history.extra["comm_per_round"] = list(history.comm)
    if history.extras is not None:
        history.extra.update(dataclasses.asdict(history.extras))
    if keep_state:
        history.final_params, history.final_opt_state = stacked, opt_state
    return history


# ---------------------------------------------------------------------------
# the fused superstep: eval_every rounds as one chunk


def _mro_definer(cls: type, name: str) -> Optional[type]:
    """The class in ``cls``'s MRO that actually defines ``name``."""
    for c in cls.__mro__:
        if name in vars(c):
            return c
    return None


def superstep_support(strategy: Strategy,
                      sampler: Optional[ClientSampler],
                      hierarchy: Optional[Any] = None) -> tuple:
    """(ok, reason): whether this run qualifies for the fused superstep.

    Strategy and sampler must declare the traceability contract; every
    registered codec's ``roundtrip`` runs inside a fused round, so a
    `Channel` never blocks fusion.  A subclass of a traceable strategy
    that overrides ``aggregate`` WITHOUT re-implementing
    ``aggregate_traced`` would silently fuse with the parent's rule; it
    goes to the eventful loop instead.  A hierarchy whose edge aggregator
    weights on the host (``traceable=False``) names itself and runs
    eventful."""
    if not strategy.traceable:
        return False, (f"strategy {strategy.spec!r} is not traceable "
                       "(eventful per-round state)")
    cls = type(strategy)
    traced_at = _mro_definer(cls, "aggregate_traced")
    at = _mro_definer(cls, "aggregate")
    if at is not Strategy and not issubclass(traced_at, at):
        return False, (
            f"{cls.__name__} overrides aggregate() below the class "
            f"defining aggregate_traced ({traced_at.__name__}); the fused "
            "round would silently diverge: override aggregate_traced too "
            "(or set traceable=False)")
    if sampler is not None and not sampler.traceable:
        return False, (f"sampler {type(sampler).__name__} does not "
                       "implement sample_traced")
    if hierarchy is not None:
        agg = hierarchy.edge_aggregator
        if not agg.traceable:
            return False, (f"edge aggregator {agg.spec!r} is not traceable "
                           "(host-side edge weighting)")
    return True, ""


# built supersteps, shared across `run_federated` calls: key -> {(chunk
# length, input shapes) -> chunk, ("statics", shapes) -> static buffers}.
# The key holds everything the round function closes over (the cached
# update step carries the loss_fn / FLConfig identity; strategy and
# sampler their spec-level identities; the placement its own; ``acc_fn``
# the chunk-end eval).  LRU, bounded: a sweep over many configurations
# does not pin every captured graph.
_SUPERSTEP_FNS: Dict[tuple, Dict] = {}
_SUPERSTEP_CACHE_MAX = 32


def _superstep_cache(placement: Placement, strategy: Strategy,
                     sampler: Optional[ClientSampler], codec,
                     error_feedback: bool, update_fn: Callable,
                     acc_fn: Callable, fault_cfg: Optional[Any] = None,
                     robust_spec: Optional[str] = None,
                     min_quorum: Optional[int] = None) -> Dict:
    # the fault injector, the defense and the quorum gate run inside the
    # round function a cached chunk holds: their identity is in the key
    key = (placement.cache_key(), type(strategy), strategy.spec,
           None if sampler is None else sampler.cache_key,
           codec, bool(error_feedback), update_fn, acc_fn,
           fault_cfg, robust_spec, min_quorum)
    cache = _SUPERSTEP_FNS.pop(key, None)   # re-insert: LRU, not FIFO
    if cache is None:
        while len(_SUPERSTEP_FNS) >= _SUPERSTEP_CACHE_MAX:
            _SUPERSTEP_FNS.pop(next(iter(_SUPERSTEP_FNS)))
        cache = {}
    _SUPERSTEP_FNS[key] = cache
    return cache


def _build_traced_round(strategy: Strategy, sampler: Optional[ClientSampler],
                        codec, error_feedback: bool, placement: Placement,
                        update_fn: Callable, m: int,
                        fault_plan: Optional[Any] = None,
                        defense: Optional[Any] = None,
                        min_quorum: Optional[int] = None) -> Callable:
    """The fused round (local update → sampler select → fault injection →
    codec uplink with error feedback → screening/robust defense →
    strategy aggregate → quorum gate) as one function

        round_fn((stacked, opt_state, ef), data, consts,
                 (idx, mask, noise, faults))
            -> ((stacked', opt_state', ef'), (crash, quarantine))

    of the eventful round's arithmetic, op for op, on the round's draws
    (``mask`` all-True where the eventful sampler gives None: the select
    is then a bitwise identity).  ``data`` is ``(x, y, n)`` and ``idx``
    the update step's draw (a hierarchy run's: its `FleetDraws`): the
    update step takes ``(*data, idx)``.  With
    ``fault_plan``, ``consts`` is the pair ``(strategy_consts,
    byz_row)`` (the static adversary row rides as an input) and
    ``faults`` the round's `FaultDraws`.  ``min_quorum``
    snapshots the clients' own models before the uplink and keeps them
    when too few rows took part: the mix always runs and a ``where``
    picks, so the round has one shape whatever the count.  ``crash`` and
    ``quarantine`` are the round's (m,) rows, or None where the axis is
    off.  It reads nothing back to the host: on the card it runs inside
    a captured CUDA graph.

    The draws hold every one of the ``m`` clients' rows, and the
    placement's `rows` cuts them to the stack's (a mesh rank's shard; all
    of them on `HostVmap`); the sampler and crash rows stay whole for the
    quorum count and the host's books."""
    tmix = TracedMix(placement)
    rows = placement.rows
    lossy = codec is not None and not codec.is_identity
    faulted = fault_plan is not None

    def round_fn(carry, data, consts, draw):
        if faulted:
            consts, byz_row = consts
        stacked, opt_state, ef = carry
        idx, mask, noise, fd = draw
        prev, prev_opt = stacked, opt_state
        stacked, opt_state = update_fn(stacked, opt_state, *data, rows(idx))
        if sampler is not None:
            stacked = placement.select(rows(mask), stacked, prev)
            opt_state = placement.select(rows(mask), opt_state, prev_opt)
        crash = None
        if faulted:
            if fault_plan.value_faults:
                stacked = inject_values(fault_plan, rows(byz_row), stacked,
                                        prev, rows(fd), rows=rows(mask))
            crash = crash_mask(fault_plan, fd)
            if crash is not None:
                # a crashed client never reports: row rollback, exactly a
                # sampler no-show
                stacked = placement.select(~rows(crash), stacked, prev)
                opt_state = placement.select(~rows(crash), opt_state,
                                             prev_opt)
        part = mask
        if crash is not None:
            part = ~crash if part is None else part & ~crash
        # quorum snapshot: the clients' own post-update models BEFORE the
        # uplink; on a skipped round each keeps what it computed
        clients = stacked if min_quorum is not None else None
        if lossy:
            stacked, new_ef = placement.uplink(codec, stacked, prev, ef,
                                               rows(noise), rows(part))
            ef = new_ef if error_feedback else ef
        q = None
        if defense is not None:
            stacked, q = screen_and_defend(defense, stacked, prev,
                                           placement)
            tmix.quarantine = q
        stacked = strategy.aggregate_traced(consts, stacked, prev, tmix)
        tmix.quarantine = None
        if min_quorum is not None:
            if part is None:            # everyone took part: m is known
                if m < min_quorum:
                    stacked = clients
            else:
                ok = part.to(torch.float32).sum() >= float(min_quorum)
                stacked = {k: torch.where(ok, a, clients[k])
                           for k, a in stacked.items()}
        return (stacked, opt_state, ef), (crash, q)

    return round_fn


def _eval_rounds(rounds: int, eval_every: int):
    """The eventful engine's eval boundaries (``rnd % eval_every == 0 or
    rnd == rounds - 1``) as consecutive chunks: yields ``(first, last)``
    round of each."""
    rnd = 0
    while rnd < rounds:
        nxt = min(((rnd + eval_every - 1) // eval_every) * eval_every,
                  rounds - 1)
        yield rnd, nxt
        rnd = nxt + 1


def _run_superstep(strategy: Strategy, fed: FederatedData, *,
                   sampler: Optional[ClientSampler], fl: FLConfig,
                   model_init: Optional[Callable], loss_fn: Callable,
                   acc_fn: Callable, system: Optional[SystemModel],
                   placement: Placement, channel: Optional[Channel],
                   keep_state: bool, seed: int, draws: Any, device,
                   faults: Optional[Any] = None,
                   robust_agg: Optional[Any] = None,
                   min_quorum: Optional[int] = None,
                   hierarchy: Optional[Any] = None) -> History:
    """The fused run: chunk by chunk (`_eval_rounds`), the chunk's draws
    taken first, its rounds and chunk-end eval run by
    `Placement.run_supersteps`, its scores and its rounds' crash and
    quarantine rows brought back in one copy, then the clock, comm, edge
    and fault accounting replayed on the host in the eventful engine's
    per-round order (`charge_round`, `charge_faults`)."""
    m = fed.m
    update_fn, stacked, opt_state, data, ctx, state = init_run(
        strategy, fed, fl, model_init, loss_fn, acc_fn, placement, seed,
        draws, device, faults=faults, hierarchy=hierarchy, system=system)
    x, _, n = data
    n = placement.gather(n)     # the draws' counts: every client's
    meter = (None if ctx.hierarchy_plan is None
             else EdgeMeter(ctx.hierarchy_plan))
    plan = ctx.fault_plan
    defense = get_robust_aggregator(robust_agg)
    robust_spec = "none" if defense is None else str(robust_agg)
    fmeter = None
    if plan is not None or defense is not None or min_quorum is not None:
        fmeter = FaultMeter(plan, robust_spec, min_quorum)
    payload, link, model_bits, ef, channel = init_channel(
        channel, ctx, stacked, system, m)
    lossy = channel is not None and not channel.codec.is_identity
    # identity codecs run no uplink: channel-less and identity-channel runs
    # share one superstep
    codec = channel.codec if lossy else None
    ef_flag = channel.error_feedback if lossy else True
    consts = strategy.traced_state(state)
    if plan is not None:
        # the static adversary row rides as an input of the chunk
        consts = (consts, torch.from_numpy(plan.byz_row()).to(x.device))
    round_fn = _build_traced_round(strategy, sampler, codec, ef_flag,
                                   placement, update_fn, m, fault_plan=plan,
                                   defense=defense, min_quorum=min_quorum)
    cache = _superstep_cache(placement, strategy, sampler, codec, ef_flag,
                             update_fn, acc_fn,
                             fault_cfg=None if plan is None else plan.cfg,
                             robust_spec=robust_spec, min_quorum=min_quorum)
    eval_fn = lambda st, ed: placement.eval_traced(acc_fn, st, ed[0], ed[1])
    # round-constant by the traceability contract: read once, as the
    # eventful loop would read them every round
    cost = strategy.comm(state)
    assignment = None if link is None else strategy.membership(state)
    ul_bits_pc = per_client_uplink_bits(channel, ctx, payload, m)
    d = sum(leaf[0].numel() for leaf in stacked.values())
    noise_d = d if lossy and codec.needs_noise else None

    history = History()
    t_accum = 0.0
    carry = (stacked, opt_state, ef if lossy else None)
    for rnd, nxt in _eval_rounds(fl.rounds, fl.eval_every):
        length = nxt - rnd + 1
        cd = chunk_draws(draws, range(rnd, nxt + 1), step=update_fn, x=x,
                         n=n, sampler=sampler, m=m, noise_d=noise_d,
                         device=x.device,
                         fault_cfg=None if plan is None else plan.cfg,
                         fault_d=d)
        carry, accs, (crashes, qs) = placement.run_supersteps(
            round_fn, carry, data, consts, length, cache=cache,
            eval_fn=eval_fn, eval_data=(fed.x_val, fed.y_val),
            draws=(cd.slots, cd.mask, cd.noise, cd.faults))
        # the chunk's one copy to the host: the scores' mean and min, and
        # the rounds' crash and quarantine rows
        parts = [score_stats(accs)] + [r.reshape(-1).to(torch.float32)
                                       for r in (crashes, qs)
                                       if r is not None]
        host = torch.cat(parts).cpu().numpy()
        mean_acc, worst_acc = float(host[0]), float(host[1])
        rows, at = [], 2
        for r in (crashes, qs):
            if r is None:
                rows.append(None)
            else:
                rows.append(host[at:at + r.numel()].reshape(tuple(r.shape)))
                at += r.numel()
        crashes_np, qs_np = rows
        for i in range(length):
            mrow = None if cd.mask_np is None else cd.mask_np[i]
            crow = None if crashes_np is None else crashes_np[i] > 0
            eff = mrow
            if crow is not None:
                eff = ~crow if eff is None else eff & ~crow
            n_eff = m if eff is None else int(eff.sum())
            ok = min_quorum is None or n_eff >= min_quorum
            # a quorum-skipped round moves no server model: no downlink
            # streams, no membership-aware broadcast; the clients did
            # compute and upload
            t_accum = charge_round(
                history, cost if ok else CommCost(0, 0), eff, m, payload,
                link, system, channel, t_accum,
                assignment if ok else None, ul_bits_pc, meter)
            if fmeter is not None:
                charge_faults(fmeter, crow,
                              None if qs_np is None else qs_np[i], eff,
                              n_eff, ok, channel, payload, ul_bits_pc)
        record_eval(history, nxt, mean_acc, worst_acc, t_accum)

    if keep_state:
        # on the card the carry is the chunks' static buffers, which the
        # next run of this configuration overwrites
        carry = placement.gather(tree_map(torch.clone, carry))
    stacked, opt_state, ef = carry
    history = finalize_history(history, strategy, state, keep_state, stacked,
                               opt_state)
    if meter is not None:
        history.extra["hierarchy"] = meter.extra()
    if fmeter is not None:
        history.extra["faults"] = fmeter.extra()
    if channel is not None:
        channel_extra(history, channel, link, model_bits, payload)
        if keep_state:
            history.final_residual = ef
    return history


def run_federated(algorithm: Union[str, Strategy, None] = None,
                  fed: Optional[FederatedData] = None, *,
                  strategy: Optional[Strategy] = None,
                  sampler: Optional[ClientSampler] = None,
                  fl: Optional[FLConfig] = None,
                  model_init: Optional[Callable] = None,
                  loss_fn: Callable = lenet.loss_fn,
                  acc_fn: Callable = lenet.accuracy,
                  system: Optional[SystemModel] = None,
                  placement: Optional[Placement] = None,
                  channel: Union[str, Channel, None] = None,
                  keep_state: bool = False,
                  async_cfg: Optional[Any] = None,
                  superstep: Optional[bool] = None,
                  paging: Optional[Any] = None,
                  hierarchy: Optional[Any] = None,
                  faults: Optional[Any] = None,
                  robust_agg: Optional[Any] = None,
                  min_quorum: Optional[int] = None,
                  seed: int = 0,
                  draws: Optional[Any] = None,
                  device: DeviceLike = "cuda") -> History:
    """Run one strategy on one scenario; returns the accuracy/time history.

    ``algorithm`` is a registry spec (``"fedavg"``, ``"ucfl"``,
    ``"ucfl_k4"``, ``"cfl"``, ``"fedfomo"``) or a `Strategy`;
    alternatively pass ``strategy=``.  ``fed`` must live on ``device``.
    ``model_init`` is called with a `torch.Generator` on ``device`` and
    returns the param dict (default: LeNet-5 sized to the scenario).
    ``sampler`` (`UniformFraction`, `FullParticipation`) selects each
    round's participants (default: everyone).  ``channel`` (a `Channel`
    or codec spec string) turns on bit-level payload accounting, uplink
    compression with error feedback and per-client link timing;
    ``Channel()`` (identity codec, uniform link) is bit-identical to no
    channel.  ``faults`` (a `FaultConfig` or spec string such as
    ``"crash:0.1,byz:0.25:sign_flip"``) injects seeded client failures;
    ``robust_agg`` (``none | clip:<c> | trimmed_mean:<f> | median |
    krum:<f>`` or a `RobustAggregator`) screens non-finite uploads and
    robustifies the aggregation; ``min_quorum`` skips the aggregation on
    rounds where fewer clients take part.  All three default off, off is
    the faults-off engine, and on, the run's fault ledger lands in
    ``History.extra["faults"]``.  ``draws`` supplies the run's random
    draws (default `TorchDraws(seed, device)`).  ``keep_state=True``
    attaches the final stacked params / opt state to the History.
    ``superstep`` None (default) fuses the rounds between two evals into
    one chunk exactly when `superstep_support` allows it (on the card a
    captured CUDA graph; bitwise the eventful run's history either way),
    False forces the eventful per-round loop, True raises `ValueError` if
    the run cannot fuse.  ``async_cfg`` (an `AsyncConfig`) runs the
    buffered-async event loop instead (`run_async`): it takes no
    ``sampler`` and no ``superstep=True`` (`TypeError`), and
    ``superstep=None`` does not fuse it.  ``paging`` (a `PagingConfig`)
    runs the cohort paging engine (`run_paged`): the population's state
    and data stay on the host, one cohort at a time on ``device``, and
    ``fed`` may then live on the host; it needs a run that can fuse
    (`ValueError` otherwise) and refuses ``superstep=False`` and
    ``hierarchy`` (`TypeError`).  ``hierarchy`` (a `HierarchyConfig`,
    an int devices-per-user or a fleet spec string such as
    ``"ragged:2-4"``) nests an edge sub-round inside every round: each
    user aggregates its device fleet before the server sees it, both
    hops are charged, and the edge books land in
    ``History.extra["hierarchy"]``; a host-side edge aggregator runs the
    eventful loop.
    """
    if min_quorum is not None:
        min_quorum = int(min_quorum)
        if min_quorum < 1:
            raise ValueError(f"min_quorum must be >= 1, got {min_quorum}")
    faults = resolve_faults(faults)     # validates the spec once, up front
    if hierarchy is not None:
        hierarchy = resolve_hierarchy(hierarchy)
    if async_cfg is not None:
        if sampler is not None:
            raise TypeError("the async runtime takes no ClientSampler — "
                            "the arrival buffer is the per-event cohort")
        if superstep:
            raise TypeError("superstep fusion is a synchronous-engine "
                            "feature; the async runtime is event-driven")
        from repro_torch.fl.runtime import run_async
        return run_async(algorithm, fed, strategy=strategy,
                         async_cfg=async_cfg, fl=fl, model_init=model_init,
                         loss_fn=loss_fn, acc_fn=acc_fn, system=system,
                         placement=placement, channel=channel,
                         keep_state=keep_state, paging=paging,
                         hierarchy=hierarchy, faults=faults,
                         robust_agg=robust_agg, min_quorum=min_quorum,
                         seed=seed, draws=draws, device=device)
    if paging is not None:
        if hierarchy is not None:
            raise TypeError("the hierarchy tier does not compose with the "
                            "cohort paging engine yet (the store pages "
                            "flat client rows, not device fleets)")
        if superstep is False:
            raise TypeError("the paging engine runs fused supersteps only; "
                            "superstep=False cannot page")
        from repro_torch.fl.population import run_paged
        return run_paged(algorithm, fed, paging=paging, strategy=strategy,
                         sampler=sampler, fl=fl, model_init=model_init,
                         loss_fn=loss_fn, acc_fn=acc_fn, system=system,
                         placement=placement, channel=channel,
                         keep_state=keep_state, faults=faults,
                         robust_agg=robust_agg, min_quorum=min_quorum,
                         seed=seed, draws=draws, device=device)
    dev = resolve_device(device)
    strategy = resolve_strategy(algorithm, strategy)
    if fed is None:
        raise TypeError("`fed` is required")
    if fed.x.device != dev:
        raise ValueError(f"fed lives on {fed.x.device}, run asked for "
                         f"device={str(device)!r}")
    fl = FLConfig() if fl is None else fl
    placement = resolve_placement(placement)
    channel = resolve_channel(channel)
    lossy = channel is not None and not channel.codec.is_identity
    draws = TorchDraws(seed, dev) if draws is None else draws
    if not placement.holds_clients(fed.m):
        # a mesh rank beyond the client axis: rank 0's History
        return placement.share(None)
    if superstep is None or superstep:
        ok, why = superstep_support(strategy, sampler, hierarchy=hierarchy)
        if not ok and superstep:
            raise ValueError(f"superstep=True but this run cannot fuse: "
                             f"{why}")
        if ok:
            return placement.share(_run_superstep(
                strategy, fed, sampler=sampler, fl=fl, model_init=model_init,
                loss_fn=loss_fn, acc_fn=acc_fn, system=system,
                placement=placement, channel=channel, keep_state=keep_state,
                seed=seed, draws=draws, device=dev, faults=faults,
                robust_agg=robust_agg, min_quorum=min_quorum,
                hierarchy=hierarchy))
    m = fed.m
    defense = get_robust_aggregator(robust_agg)
    update_fn, stacked, opt_state, data, ctx, state = init_run(
        strategy, fed, fl, model_init, loss_fn, acc_fn, placement, seed,
        draws, dev, faults=faults, hierarchy=hierarchy, system=system)
    x, _, n = data
    n = placement.gather(n)     # the draws' counts: every client's
    rows = placement.rows
    meter = (None if ctx.hierarchy_plan is None
             else EdgeMeter(ctx.hierarchy_plan))
    plan = ctx.fault_plan
    robust_spec = "none" if defense is None else str(robust_agg)
    byz_row = (None if plan is None
               else torch.from_numpy(plan.byz_row()).to(dev))
    fmeter = None
    if plan is not None or defense is not None or min_quorum is not None:
        fmeter = FaultMeter(plan, robust_spec, min_quorum)
    payload, link, model_bits, ef, channel = init_channel(
        channel, ctx, stacked, system, m)
    ul_bits_pc = per_client_uplink_bits(channel, ctx, payload, m)
    d = sum(leaf[0].numel() for leaf in stacked.values())

    history = History()
    t_accum = 0.0
    for rnd in range(fl.rounds):
        # every draw is taken for all m clients, then cut to the rows
        # this placement holds (all of them on HostVmap)
        idx = update_fn.draw(draws, rnd, x, n)
        # the update is functional: prev and prev_opt stay intact
        prev, prev_opt = stacked, opt_state
        stacked, opt_state = update_fn(stacked, opt_state, *data, rows(idx))
        mask_np = mask = None
        if sampler is not None:
            cpu_mask = sampler.sample(rnd, m, draws)
            if cpu_mask is not None:
                # non-participants keep their pre-round model and optimizer
                mask_np, mask = cpu_mask.numpy(), cpu_mask.to(dev)
                stacked = placement.select(rows(mask), stacked, prev)
                opt_state = placement.select(rows(mask), opt_state, prev_opt)
        crash = None
        if plan is not None:
            # value faults corrupt what the row transmits; a crash rolls
            # the row back like a no-show
            fd = round_fault_draws(draws, rnd, m, d, plan.cfg, dev)
            if plan.value_faults:
                stacked = inject_values(plan, rows(byz_row), stacked, prev,
                                        rows(fd), rows=rows(mask))
            crash = crash_mask(plan, fd)
            if crash is not None:
                stacked = placement.select(~rows(crash), stacked, prev)
                opt_state = placement.select(~rows(crash), opt_state,
                                             prev_opt)
        part = mask
        if crash is not None:
            part = ~crash if part is None else part & ~crash
        # quorum snapshot: the clients' own post-update models BEFORE the
        # uplink; on a skipped round each keeps what it computed
        clients_snap = stacked if min_quorum is not None else None
        if lossy:
            # the server receives the codec's decode(encode(Δ + residual))
            stacked, ef = channel_uplink(placement, channel, stacked, prev,
                                         ef, draws, rnd, rows(part), m)
        q = None
        if defense is not None:
            # screening + robust aggregation, before the strategy's mix
            stacked, q = screen_and_defend(defense, stacked, prev,
                                           placement)
        eff_np = mask_np if crash is None else part.cpu().numpy()
        n_eff = m if eff_np is None else int(eff_np.sum())
        ok = min_quorum is None or n_eff >= min_quorum
        if ok:
            ctx.rnd, ctx.participation, ctx.quarantine = rnd, part, q
            stacked, state = strategy.aggregate(state, stacked, prev, ctx)
            ctx.quarantine = None
        else:
            # below quorum: the mix never happens, every client keeps its
            # own pre-uplink model and the round's uploads are wasted
            stacked = clients_snap
        # the client->stream map is read only where a link profile charges
        # per stream (it syncs with the card)
        assignment = (None if link is None or not ok
                      else strategy.membership(state))
        t_accum = charge_round(history,
                               strategy.comm(state) if ok else CommCost(0, 0),
                               eff_np, m, payload, link, system, channel,
                               t_accum, assignment, ul_bits_pc, meter)
        if fmeter is not None:
            charge_faults(fmeter,
                          None if crash is None else crash.cpu().numpy(),
                          None if q is None else q.cpu().numpy(), eff_np,
                          n_eff, ok, channel, payload, ul_bits_pc)
        if rnd % fl.eval_every == 0 or rnd == fl.rounds - 1:
            mean_acc, worst_acc = placement.evaluate(acc_fn, stacked, fed)
            record_eval(history, rnd, mean_acc, worst_acc, t_accum)

    if keep_state:
        stacked, opt_state, ef = placement.gather((stacked, opt_state, ef))
    history = finalize_history(history, strategy, state, keep_state, stacked,
                               opt_state)
    if meter is not None:
        history.extra["hierarchy"] = meter.extra()
    if fmeter is not None:
        history.extra["faults"] = fmeter.extra()
    if channel is not None:
        channel_extra(history, channel, link, model_bits, payload)
        if keep_state:
            history.final_residual = ef
    return placement.share(history)
