"""Cohort paging engine: a population far larger than the card holds.

Counterpart of `repro/fl/population/paging.py`.  `run_paged` trains a
population of n clients with only one cohort of m clients on the card
at a time:

  superstep t:  gather the cohort's rows from the `ClientStateStore`
                -> stage them host -> device (`Placement.stage`)
                -> run the resident engine's fused superstep on them
                -> snapshot rows, scores and fault rows, copy them to the
                   host (`Placement.fetch`)
                -> (meanwhile finalize chunk t-1 and stage cohort t+1)
                -> scatter the updated rows back to the store

The superstep is THE resident engine's (`repro_torch.fl.simulator`): the
same `_build_traced_round`, the same `_superstep_cache` entry, whose
chunks are keyed on the cohort's shapes and never on the population
size, so one captured CUDA graph serves every cohort and every
population, and a paged run over a `FixedCohort` is bitwise a resident
run on that sub-population (the parity anchor).  The population's data
stays on the host too (`_host_federated`): each cohort's data page is
staged with its setup, and only cohort-sized arrays cross to the card.

Each chunk's draws come from the run's ``draws`` over the cohort's m
rows (`chunk_draws`), as the reference splits its round key over the
cohort's rows.

Double buffer, both legs.  On the card a chunk returns its graph's
STATIC buffers, which the next replay overwrites: right after chunk t's
replay is enqueued, its rows, scores and fault rows are cloned on the
compute stream and copied to pinned host memory on a side stream
(`Placement.fetch`), before anything of chunk t+1 is enqueued.  Then
chunk t-1 is finalized (it waits on its own copy's event only: clock,
comm and fault accounting replayed in the eventful order, eval, scatter,
checkpoint), t+1's setup and data page are warmed and, if t+1's cohort
is disjoint from t's, its rows are staged, so the writeback and the
upload both overlap chunk t on the card.  An overlapping next cohort
skips the prefetch, and its gather waits until the pending chunk's
scatter has landed.

Checkpointing: at superstep boundaries the store rows, the draws' state
(where the reference keeps its key, taken right after the chunk's own
draws), the clock accumulator and the History go to one file.
Schedules are pure functions of the superstep index, so a resumed run
replays the exact cohort sequence: resume is bitwise.

`run_async_paged` is the buffered-async sibling: the per-event arrival
buffer IS the page request; aggregation is cohort-local (exact in the
lockstep K = m anchor, an approximation under partial buffers, where the
resident async engine mixes over the full population stack).

On `MeshShardMap` a cohort's state rows are staged and fetched by the
placement: each rank stages its rows of the cohort (`Placement.stage`)
and the chunk's rows come back all-gathered before the copy to the host,
so every rank keeps the whole store.  A cohort's data page lands whole
on every rank (its strategy setup reads every client, as the resident
engine's does), and `Placement.place_data` takes the rank's rows.  The
paged async engine's cohorts vary in size from event to event, so there
every cohort must shard over every rank (`Placement.spans`); a cohort
that does not is refused on every rank alike.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointCorruptError, paged_checkpoints,
                                    restore_paged_state, save_paged_state)
from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.channel import (Channel, ChannelCost, resolve_channel,
                                    round_downlink_time, zeros_like_stack)
from repro_torch.fl.comm import SYSTEMS, SystemModel
from repro_torch.fl.draws import (TorchDraws, chunk_draws, init_generator,
                                  round_fault_draws)
from repro_torch.fl.faults import (FaultMeter, get_robust_aggregator,
                                   inject_values, pop_with_retries,
                                   resolve_fault_plan, resolve_faults,
                                   screen_and_defend)
from repro_torch.fl.placement import (Placement, resolve_placement,
                                      score_stats)
from repro_torch.fl.placement.base import stack_params
from repro_torch.fl.placement.copies import stage_tree
from repro_torch.fl.placement.graphs import tree_map
from repro_torch.fl.population.schedule import (CohortSchedule,
                                                RandomCohorts,
                                                SequentialSweep)
from repro_torch.fl.population.store import ClientStateStore
from repro_torch.fl.simulator import (FLConfig, History, _build_traced_round,
                                      _eval_rounds, _superstep_cache,
                                      channel_extra, channel_uplink,
                                      charge_faults, charge_round,
                                      default_model_init, finalize_history,
                                      init_channel, per_client_uplink_bits,
                                      record_eval, resolve_strategy,
                                      superstep_support)
from repro_torch.fl.strategies import (ClientSampler, CommCost, RoundContext,
                                       Strategy)
from repro_torch.models import lenet

# distinct cohorts whose strategy state / placed data pages stay cached
# (sweep schedules cycle through n/m cohorts: keep the working set small)
_SETUP_CACHE_MAX = 8


@dataclass(frozen=True)
class PagingConfig:
    """Knobs of the cohort paging engine.

    cohort:           clients on the card per superstep (ignored when
                      ``schedule`` is a `CohortSchedule` instance, which
                      carries its own size).
    schedule:         ``"sweep"`` (round-robin shards) | ``"random"``
                      (seeded without-replacement draw per superstep) |
                      a `CohortSchedule` instance.
    schedule_seed:    seed of the ``"random"`` schedule.
    store_dir:        disk-back the client-state store as ``.npy``
                      memmaps (None = host RAM).
    checkpoint_dir:   write superstep-boundary snapshots here (None = no
                      checkpointing).
    checkpoint_every: snapshot cadence in supersteps.
    resume:           pick up from the latest snapshot in
                      ``checkpoint_dir`` (no-op when there is none).
    prefetch:         double-buffer the next cohort's H2D copy under the
                      running superstep (skipped when cohorts overlap).
    max_chunks:       run at most this many supersteps this invocation,
                      then return the partial History (preemption hook /
                      resume tests); None = run to completion.
    """
    cohort: int = 8
    schedule: Union[str, CohortSchedule] = "sweep"
    schedule_seed: int = 0
    store_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    resume: bool = False
    prefetch: bool = True
    max_chunks: Optional[int] = None

    def __post_init__(self):
        if self.cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {self.cohort}")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1, got "
                             f"{self.checkpoint_every}")

    def resolve_schedule(self) -> CohortSchedule:
        if isinstance(self.schedule, CohortSchedule):
            return self.schedule
        if self.schedule == "sweep":
            return SequentialSweep(self.cohort)
        if self.schedule == "random":
            return RandomCohorts(self.cohort, seed=self.schedule_seed)
        raise ValueError(f"unknown cohort schedule {self.schedule!r}; "
                         "one of sweep | random | a CohortSchedule")


def sub_federated(fed: FederatedData, idx: np.ndarray) -> FederatedData:
    """The cohort's view of the population data (row-gathered, on the
    population's device)."""
    rows = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    return FederatedData(*(t.index_select(0, rows.to(t.device))
                           for t in fed))


def _host_federated(fed: FederatedData) -> FederatedData:
    """The population's data as host rows: a cohort gather is then one
    host copy and only cohort-sized arrays cross H2D, the data half of
    the paging contract (the store is the state half).  Values are
    bitwise the same either way."""
    return FederatedData(*(t.cpu() for t in fed))


def _template(opt: Any, params0: Any, lossy: bool) -> dict:
    """One client's state row (params, optimizer state, and the EF
    residual under a lossy channel) as numpy, the store's template: the
    resident engine's initial stack, row 0."""
    one = stack_params(params0, 1)
    row = {"params": one, "opt": opt.init_stacked(one, 1)}
    if lossy:
        row["ef"] = zeros_like_stack(one)
    return tree_map(lambda t: t[0].cpu().numpy(), row)


def _final_rows(store: ClientStateStore, part: str) -> Any:
    """The store's ``part`` rows as host tensors (sharing its memory)."""
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                    store.tree[part])


# ---------------------------------------------------------------------------
# History <-> checkpoint payload (plain lists only)


def _history_state(history: History) -> dict:
    return {"rounds": list(history.rounds),
            "mean_acc": list(history.mean_acc),
            "worst_acc": list(history.worst_acc),
            "time": list(history.time),
            "comm": [[int(c.n_streams), int(c.n_unicasts)]
                     for c in history.comm],
            "comm_bits": [[int(c.dl_bits), int(c.ul_bits)]
                          for c in history.comm_bits]}


def _history_from_state(d: dict) -> History:
    h = History()
    h.rounds = [int(r) for r in d["rounds"]]
    h.mean_acc = [float(a) for a in d["mean_acc"]]
    h.worst_acc = [float(a) for a in d["worst_acc"]]
    h.time = [float(t) for t in d["time"]]
    h.comm = [CommCost(int(s), int(u)) for s, u in d["comm"]]
    h.comm_bits = [ChannelCost(int(dl), int(ul))
                   for dl, ul in d["comm_bits"]]
    return h


class _CohortSetups:
    """Per-cohort strategy state + placed data pages, LRU by row indices.

    A cohort is its own federated sub-problem: the strategy's `setup`
    (similarity stats, mixing matrix, k-means plan) runs on the cohort's
    sub-population exactly as a resident run on that sub-fed would, the
    parity anchor's definition of correct."""

    def __init__(self, build: Callable):
        self._build = build
        self._cache: OrderedDict = OrderedDict()

    def get(self, idx: np.ndarray):
        k = idx.tobytes()
        if k in self._cache:
            self._cache.move_to_end(k)
            return self._cache[k]
        while len(self._cache) >= _SETUP_CACHE_MAX:
            self._cache.popitem(last=False)
        out = self._cache[k] = self._build(idx)
        return out


def _disjoint(a: np.ndarray, b: np.ndarray) -> bool:
    return np.intersect1d(a, b, assume_unique=True).size == 0


class _Pending(NamedTuple):
    """A chunk run but not yet finalized."""
    t: int                  # its index among the chunks
    last: int               # its last round (the eval's round)
    idx: np.ndarray         # its cohort's rows
    length: int             # its rounds
    fetched: Any            # `Fetched` of (rows, [mean, min, crash, q])
    fault_shapes: tuple     # the (L, m) shape of its crash / quarantine
                            # rows, None where the axis is off
    mask_np: Optional[np.ndarray]   # its rounds' sampler masks
    cost: CommCost
    assignment: Optional[np.ndarray]
    draws_state: Any        # the draws' state after its own draws


def _stage_data(placement: Placement, fed: FederatedData, idx: np.ndarray,
                dev: torch.device) -> FederatedData:
    """The cohort's data page on ``dev``, ready on the current stream:
    every client's rows (the setup reads them all)."""
    return stage_tree(sub_federated(fed, idx), dev).wait()


# ---------------------------------------------------------------------------
# the paged synchronous engine


def run_paged(algorithm: Union[str, Strategy, None] = None,
              fed: Optional[FederatedData] = None, *,
              paging: PagingConfig,
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
              faults: Optional[Any] = None,
              robust_agg: Optional[Any] = None,
              min_quorum: Optional[int] = None,
              seed: int = 0,
              draws: Optional[Any] = None,
              device: DeviceLike = "cuda") -> History:
    """Paged synchronous run: `run_federated` semantics per cohort, the
    population paged through the host-backed store (module docstring).
    ``fed`` may live on the host or on ``device``; it is kept on the host.
    Returns History; ``keep_state=True`` attaches the FULL population's
    final params / opt state (and EF residuals under a lossy channel) as
    host tensors sharing the store's memory.  ``faults`` / ``robust_agg``
    / ``min_quorum`` work per cohort: the `FaultPlan` is resolved ONCE at
    the population size and each cohort's adversary row is gathered into
    the superstep ``consts``, so per-cohort rows never rebuild the
    chunk."""
    dev = resolve_device(device)
    strategy = resolve_strategy(algorithm, strategy)
    if fed is None:
        raise TypeError("`fed` is required")
    fl = FLConfig() if fl is None else fl
    placement = resolve_placement(placement)
    channel = resolve_channel(channel)
    ok, why = superstep_support(strategy, sampler)
    if not ok:
        raise ValueError(
            f"paged execution needs the fused superstep but this run "
            f"cannot fuse: {why}")

    n = fed.m
    plan = resolve_fault_plan(resolve_faults(faults), n)
    defense = get_robust_aggregator(robust_agg)
    robust_spec = "none" if defense is None else str(robust_agg)
    fmeter = None
    if plan is not None or defense is not None or min_quorum is not None:
        fmeter = FaultMeter(plan, robust_spec, min_quorum)
    sched = paging.resolve_schedule()
    m_c = sched.cohort
    if m_c > n:
        raise ValueError(f"cohort {m_c} > population {n}")
    if not placement.holds_clients(m_c):
        # a mesh rank beyond the client axis: rank 0's History
        return placement.share(None)
    fed = _host_federated(fed)
    draws = TorchDraws(seed, dev) if draws is None else draws

    # the resident prologue (`init_run`): the model init from the seed's
    # generator, the cached update step
    if model_init is None:
        model_init = default_model_init(fed)
    params0 = model_init(init_generator(seed, dev))
    opt, update_fn = placement.build_update(loss_fn, fl)

    # channel bound at COHORT size: links/payloads describe the m_c
    # slots on the card (per-slot approximation for rate-adaptive links,
    # exact for the uniform-codec paths the anchors pin)
    ctx_pop = RoundContext(fed=fed, fl=fl, loss_fn=loss_fn, acc_fn=acc_fn,
                           params0=params0, seed=seed, draws=draws,
                           placement=placement, strategy=strategy)
    payload, link, model_bits, _, channel = init_channel(
        channel, ctx_pop, stack_params(params0, 1), system, m_c)
    lossy = channel is not None and not channel.codec.is_identity
    codec = channel.codec if lossy else None
    ef_flag = channel.error_feedback if lossy else True
    ul_bits_pc = per_client_uplink_bits(channel, ctx_pop, payload, m_c)
    d = sum(leaf.numel() for leaf in params0.values())
    noise_d = d if lossy and codec.needs_noise else None

    # the full population's state rows on the host, one broadcast
    # template each
    store = ClientStateStore.create(_template(opt, params0, lossy),
                                    n, directory=paging.store_dir)

    # THE resident engine's superstep: same round function, same cache
    # entry (one captured chunk serves every cohort and population)
    round_fn = _build_traced_round(strategy, sampler, codec, ef_flag,
                                   placement, update_fn, m_c,
                                   fault_plan=plan,
                                   defense=defense, min_quorum=min_quorum)
    cache = _superstep_cache(placement, strategy, sampler, codec, ef_flag,
                             update_fn, acc_fn,
                             fault_cfg=None if plan is None else plan.cfg,
                             robust_spec=robust_spec, min_quorum=min_quorum)
    eval_fn = lambda st, ed: placement.eval_traced(acc_fn, st, ed[0], ed[1])

    def build_setup(idx: np.ndarray):
        sub = _stage_data(placement, fed, idx, dev)
        ctx = RoundContext(fed=sub, fl=fl, loss_fn=loss_fn, acc_fn=acc_fn,
                           params0=params0, seed=seed, draws=draws,
                           placement=placement, strategy=strategy)
        state = strategy.setup(ctx)
        consts = strategy.traced_state(state)
        if plan is not None:
            # the cohort-gathered adversary row, a const input of the chunk
            consts = (consts, torch.from_numpy(plan.byz_row(idx)).to(dev))
        return (state, consts, strategy.comm(state),
                None if link is None else strategy.membership(state),
                placement.place_data(sub), (sub.x_val, sub.y_val), sub.n)

    setups = _CohortSetups(build_setup)
    chunks = list(_eval_rounds(fl.rounds, fl.eval_every))
    meta = {"population": n, "cohort": m_c, "schedule": sched.spec,
            "strategy": strategy.spec, "seed": seed, "rounds": fl.rounds,
            "eval_every": fl.eval_every, "lossy": lossy,
            "faults": "none" if plan is None else plan.cfg.spec,
            "robust_agg": robust_spec, "min_quorum": min_quorum}
    keeps_draws = paging.checkpoint_dir and hasattr(draws, "state_dict")

    history = History()
    t_accum = 0.0
    start_chunk = 0
    if paging.resume and paging.checkpoint_dir:
        # fallback chain: newest snapshot first, skipping any that fail
        # the integrity check (one torn or bit-rotted newest file costs
        # at most one checkpoint cadence of recompute)
        for ck_path in paged_checkpoints(paging.checkpoint_dir):
            try:
                saved = restore_paged_state(ck_path, "cpu")
            except CheckpointCorruptError as e:
                warnings.warn(
                    f"paged checkpoint {ck_path} failed its integrity "
                    f"check ({e}); falling back to the previous intact "
                    "snapshot", RuntimeWarning, stacklevel=2)
                continue
            saved_meta = dict(saved["meta"])
            # checkpoints written before the fault layer carry no fault
            # keys: they were written by faults-off runs
            saved_meta.setdefault("faults", "none")
            saved_meta.setdefault("robust_agg", "none")
            saved_meta.setdefault("min_quorum", None)
            if saved_meta != meta:
                raise ValueError(
                    f"checkpoint {ck_path} was written by a different run "
                    f"configuration: {saved_meta} != {meta}")
            store = ClientStateStore.from_state_dict(
                saved["store"], directory=paging.store_dir)
            history = _history_from_state(saved["history"])
            t_accum = float(saved["t_accum"])
            if saved.get("draws") is not None:
                draws.load_state_dict(saved["draws"])
            start_chunk = int(saved["chunk"]) + 1
            break

    state = None
    staged, staged_for = None, None
    pending = None      # the chunk run but not yet finalized
    done_chunks = 0

    def finalize(p: _Pending) -> None:
        """Drain chunk ``p``: wait on its copy to the host alone, replay
        its clock, comm and fault accounting in the eventful order
        (`charge_round`, `charge_faults`, as the resident fused engine),
        record its eval, scatter its rows, maybe checkpoint."""
        nonlocal t_accum
        out, small = p.fetched.wait()
        small = small.numpy()
        mean_acc, worst_acc = float(small[0]), float(small[1])
        rows, at = [], 2
        for shape in p.fault_shapes:
            if shape is None:
                rows.append(None)
            else:
                size = int(np.prod(shape))
                rows.append(small[at:at + size].reshape(shape))
                at += size
        crashes_np, qs_np = rows
        for i in range(p.length):
            mrow = None if p.mask_np is None else p.mask_np[i]
            crow = None if crashes_np is None else crashes_np[i] > 0
            eff = mrow
            if crow is not None:
                eff = ~crow if eff is None else eff & ~crow
            n_eff = m_c if eff is None else int(eff.sum())
            ok_q = min_quorum is None or n_eff >= min_quorum
            t_accum = charge_round(
                history, p.cost if ok_q else CommCost(0, 0), eff, m_c,
                payload, link, system, channel, t_accum,
                p.assignment if ok_q else None, ul_bits_pc)
            if fmeter is not None:
                charge_faults(fmeter, crow,
                              None if qs_np is None else qs_np[i], eff,
                              n_eff, ok_q, channel, payload, ul_bits_pc)
        record_eval(history, p.last, mean_acc, worst_acc, t_accum)
        store.scatter(p.idx, out)

        if paging.checkpoint_dir and (
                (p.t + 1) % paging.checkpoint_every == 0
                or p.t == len(chunks) - 1):
            store.flush()
            save_paged_state(paging.checkpoint_dir, p.t, {
                "draws": p.draws_state,
                "t_accum": float(t_accum),
                "history": _history_state(history),
                "store": store.state_dict(),
                "meta": meta})

    for t, (rnd, nxt) in enumerate(chunks):
        if t < start_chunk:
            continue
        if paging.max_chunks is not None and done_chunks >= paging.max_chunks:
            break
        idx = sched.indices(t, n)
        if pending is not None and not _disjoint(pending.idx, idx):
            finalize(pending)   # overlapping rows: the scatter must land
            pending = None      # before this cohort's gather
        (state, consts, cost, assignment, data, eval_data,
         n_c) = setups.get(idx)
        if staged is not None and staged_for == idx.tobytes():
            rows = staged
        else:
            rows = placement.stage(store.gather(idx), m_c, dev)
        staged, staged_for = None, None
        rows = rows.wait()
        carry = (rows["params"], rows["opt"], rows.get("ef"))

        length = nxt - rnd + 1
        cd = chunk_draws(draws, range(rnd, nxt + 1), step=update_fn,
                         x=data[0], n=n_c, sampler=sampler, m=m_c,
                         noise_d=noise_d, device=dev,
                         fault_cfg=None if plan is None else plan.cfg,
                         fault_d=d)
        # the resume point: the draws' state right after this chunk's own
        draws_state = draws.state_dict() if keeps_draws else None
        carry, accs, (crashes, qs) = placement.run_supersteps(
            round_fn, carry, data, consts, length, cache=cache,
            eval_fn=eval_fn, eval_data=eval_data,
            draws=(cd.slots, cd.mask, cd.noise, cd.faults))
        # the D2H leg, enqueued before anything of the next chunk: on the
        # card these are the graph's static buffers, which its next
        # replay overwrites
        out = {"params": carry[0], "opt": carry[1]}
        if lossy:
            out["ef"] = carry[2]
        small = torch.cat([score_stats(accs)]
                          + [r.reshape(-1).to(torch.float32)
                             for r in (crashes, qs) if r is not None])
        fetched = placement.fetch((placement.gather(out), small), dev)

        # double buffer: finalize the PREVIOUS chunk (its copy has been
        # under way since its own replay) while this one runs, then stage
        # cohort t+1 so the upload overlaps too.  Overlapping cohorts
        # would page stale rows: their gather waits for the scatter.
        if pending is not None:
            finalize(pending)
        pending = _Pending(
            t, nxt, idx, length, fetched,
            tuple(None if r is None else tuple(r.shape)
                  for r in (crashes, qs)),
            cd.mask_np, cost, assignment, draws_state)
        done_chunks += 1
        if (paging.prefetch and t + 1 < len(chunks)
                and (paging.max_chunks is None
                     or done_chunks < paging.max_chunks)):
            nidx = sched.indices(t + 1, n)
            setups.get(nidx)    # warm t+1's setup + data page
            if _disjoint(nidx, idx):
                staged = placement.stage(store.gather(nidx), m_c, dev)
                staged_for = nidx.tobytes()

    if pending is not None:
        finalize(pending)

    if state is None:       # resumed past the end / max_chunks == 0
        last = min(max(start_chunk, 0), len(chunks) - 1)
        state = setups.get(sched.indices(last, n))[0]

    history = finalize_history(history, strategy, state, keep_state,
                               _final_rows(store, "params"),
                               _final_rows(store, "opt"))
    history.extra["paging"] = {
        "population": n, "cohort": m_c, "schedule": sched.spec,
        "store_bytes": int(store.nbytes),
        "store_dir": paging.store_dir, "chunks": len(chunks),
        "resumed_at": start_chunk if start_chunk else None}
    if fmeter is not None:
        history.extra["faults"] = fmeter.extra()
    if channel is not None:
        channel_extra(history, channel, link, model_bits, payload)
        if keep_state and lossy:
            history.final_residual = _final_rows(store, "ef")
    return placement.share(history)


# ---------------------------------------------------------------------------
# the paged buffered-async engine


def _check_spans(placement: Placement, k: int) -> None:
    """Refuse, on every process alike, a cohort of ``k`` that does not
    shard over every process: an event's cohort varies in size, and a
    process left without rows could neither go on nor return."""
    if not placement.spans(k):
        raise ValueError(
            f"a cohort of {k} clients does not cover every process of "
            f"{placement!r}: the paged async engine needs every event's "
            "cohort sharded over all of them (on the mesh: buffer_k and "
            "each event's cohort divisible by the world size)")


def run_async_paged(algorithm: Union[str, Strategy, None] = None,
                    fed: Optional[FederatedData] = None, *,
                    paging: PagingConfig,
                    strategy: Optional[Strategy] = None,
                    async_cfg: Optional[Any] = None,
                    fl: Optional[FLConfig] = None,
                    model_init: Optional[Callable] = None,
                    loss_fn: Callable = lenet.loss_fn,
                    acc_fn: Callable = lenet.accuracy,
                    system: Optional[SystemModel] = None,
                    placement: Optional[Placement] = None,
                    channel: Union[str, Channel, None] = None,
                    keep_state: bool = False,
                    faults: Optional[Any] = None,
                    robust_agg: Optional[Any] = None,
                    min_quorum: Optional[int] = None,
                    seed: int = 0,
                    draws: Optional[Any] = None,
                    device: DeviceLike = "cuda") -> History:
    """Store-backed buffered-async run: each event's arrival buffer is
    the page request.  Its k rows are gathered and staged, updated,
    aggregated COHORT-LOCALLY, evaluated on the cohort and scattered back
    (a blocking copy to the host); device memory scales with
    ``buffer_k``, not the population.  The event's batch slots, fault
    draws and codec noise are drawn over its k rows (``draws`` with the
    event index as the round).  Lockstep anchor: with ``buffer_k`` equal
    to the population on the reliable system this is bitwise the
    resident `run_async`; under partial buffers the cohort-local mix is
    the paged approximation of the resident full-stack mix."""
    from repro_torch.fl.runtime.clock import VirtualClock
    from repro_torch.fl.runtime.engine import AsyncConfig

    dev = resolve_device(device)
    strategy = resolve_strategy(algorithm, strategy)
    if fed is None:
        raise TypeError("`fed` is required")
    cfg = AsyncConfig() if async_cfg is None else async_cfg
    fl = FLConfig() if fl is None else fl
    system = SYSTEMS["wired"] if system is None else system
    placement = resolve_placement(placement)
    channel = resolve_channel(channel)

    n = fed.m
    k_buf = min(cfg.buffer_k, n)
    tau = np.inf if cfg.max_staleness is None else float(cfg.max_staleness)
    fed = _host_federated(fed)
    plan = resolve_fault_plan(resolve_faults(faults), n)
    defense = get_robust_aggregator(robust_agg)
    robust_spec = "none" if defense is None else str(robust_agg)
    fmeter = None
    if plan is not None or defense is not None or min_quorum is not None:
        fmeter = FaultMeter(plan, robust_spec, min_quorum)
    attempts: dict = {}         # per-client consecutive-crash counter
    draws = TorchDraws(seed, dev) if draws is None else draws

    if model_init is None:
        model_init = default_model_init(fed)
    params0 = model_init(init_generator(seed, dev))
    opt, update_fn = placement.build_update(loss_fn, fl)

    # link/payload resolved over the POPULATION (the clock serves all n
    # clients), exactly as the resident async engine resolves them
    ctx_pop = RoundContext(fed=fed, fl=fl, loss_fn=loss_fn, acc_fn=acc_fn,
                           params0=params0, seed=seed, draws=draws,
                           placement=placement, strategy=strategy)
    payload, link, model_bits, _, channel = init_channel(
        channel, ctx_pop, stack_params(params0, 1), system, n)
    lossy = channel is not None and not channel.codec.is_identity
    ul_bits_pc = per_client_uplink_bits(channel, ctx_pop, payload, n)
    d = sum(leaf.numel() for leaf in params0.values())

    def _ul_bits(c: int):
        return payload if ul_bits_pc is None else int(ul_bits_pc[c])

    store = ClientStateStore.create(_template(opt, params0, lossy),
                                    n, directory=paging.store_dir)

    def build_setup(idx: np.ndarray):
        sub = _stage_data(placement, fed, idx, dev)
        ctx = RoundContext(fed=sub, fl=fl, loss_fn=loss_fn, acc_fn=acc_fn,
                           params0=params0, seed=seed, draws=draws,
                           placement=placement, strategy=strategy)
        ctx.staleness_discount = cfg.staleness_discount
        ctx.staleness_schedule = cfg.staleness_schedule
        ctx.staleness_alpha = cfg.staleness_alpha
        return [strategy.setup(ctx), ctx, sub, placement.place_data(sub)]

    setups = _CohortSetups(build_setup)

    clock = VirtualClock(system, seed=seed, link=link)
    for i in range(n):
        clock.schedule(i, 0.0, ul_bits=_ul_bits(i))
    version = np.zeros(n, dtype=np.int64)

    history = History()
    t_done = 0.0
    state = None

    for event in range(fl.rounds):
        # crashed arrivals requeue with backoff (no new compute draw) and
        # die past max_retries: the resident engine's loop
        buffered = []
        while len(buffered) < k_buf:
            nxt_arrival = pop_with_retries(clock, plan, cfg.max_retries,
                                           cfg.retry_backoff, attempts,
                                           fmeter)
            if nxt_arrival is None:
                break
            buffered.append(nxt_arrival[1])
        if not buffered:
            warnings.warn(
                f"async paged run ended early at event {event}/"
                f"{fl.rounds}: every remaining client exhausted its crash "
                f"retries (dead: {sorted(fmeter.dead) if fmeter else []})",
                RuntimeWarning, stacklevel=2)
            break
        idx = np.sort(np.asarray(buffered, dtype=np.int64))
        k = idx.size
        _check_spans(placement, k)
        entry = setups.get(idx)
        state, ctx, sub, (x_c, y_c, n_c) = entry
        age = (event - version[idx]).astype(np.int64)
        fresh = age <= tau

        rows = placement.stage(store.gather(idx), k, dev).wait()
        stacked, opt_state, ef = rows["params"], rows["opt"], rows.get("ef")
        cut = placement.rows

        # drawn for the cohort's k rows, cut to the placement's
        batch_idx = update_fn.draw(draws, event, x_c, sub.n)
        prev, prev_opt = stacked, opt_state
        upd, upd_opt = update_fn(stacked, opt_state, x_c, y_c, n_c,
                                 cut(batch_idx))
        if fresh.all():
            mask = None
            stacked, opt_state = upd, upd_opt
        else:
            # stale-dropped rows keep their server-known models (they
            # still re-download the mix below, as in the resident engine)
            mask = torch.from_numpy(fresh).to(dev)
            stacked = placement.select(cut(mask), upd, prev)
            opt_state = placement.select(cut(mask), upd_opt, prev_opt)

        if plan is not None and plan.value_faults:
            # fault injection on the cohort stack; the adversary row is
            # the plan's, gathered at the cohort indices
            fd = round_fault_draws(draws, event, k, d, plan.cfg, dev)
            stacked = inject_values(
                plan, cut(torch.from_numpy(plan.byz_row(idx)).to(dev)),
                stacked, prev, cut(fd), rows=cut(mask))

        if lossy:
            stacked, ef = channel_uplink(placement, channel, stacked, prev,
                                         ef, draws, event, cut(mask), k)

        q = None
        if defense is not None:
            stacked, q = screen_and_defend(defense, stacked, prev,
                                           placement)

        n_fresh = int(fresh.sum())
        quorum_ok = min_quorum is None or n_fresh >= min_quorum
        if quorum_ok:
            ctx.rnd, ctx.participation = event, mask
            ctx.staleness = (torch.from_numpy(age.astype(np.float32)).to(dev)
                             if age.any() else None)
            ctx.quarantine = q
            stacked, state = strategy.aggregate(state, stacked, prev, ctx)
            ctx.quarantine = None
            entry[0] = state
        else:
            # below quorum: the event is undone; the cohort's rows stay
            # at their pre-event state and the uploads are wasted
            stacked, opt_state = prev, prev_opt

        # every cohort row is a buffered client: all of them download the
        # new mix and restart.  The cohort-local strategy already reports
        # cohort-sized costs; streams are capped at the cohort (exact in
        # lockstep, where cohort == population)
        ul_total = (sum(_ul_bits(c) for c in buffered)
                    if channel is not None else 0)
        if quorum_ok:
            cost = strategy.comm(state)
            cost = CommCost(min(cost.n_streams, k), cost.n_unicasts)
        else:
            cost = CommCost(0, 0)
        history.comm.append(cost)
        if channel is not None:
            history.comm_bits.append(ChannelCost(
                dl_bits=(cost.n_streams + cost.n_unicasts) * payload,
                ul_bits=ul_total))
        if quorum_ok:
            if link is not None:
                # cohort-local membership indexes cohort rows; the link
                # clock indexes by population id
                memb = strategy.membership(state)
                if memb is not None:
                    full = np.zeros(n, dtype=np.int64)
                    full[idx] = np.asarray(memb, np.int64)
                    memb = full
                duration = round_downlink_time(link, cost, payload,
                                               buffered, memb)
            else:
                duration = cost.n_streams + cost.n_unicasts
            done = clock.serve(duration, overlap=True)
        else:
            done = clock.now
        t_done = max(t_done, done)
        for c in buffered:
            clock.schedule(c, done, ul_bits=_ul_bits(c))
            if quorum_ok:
                version[c] = event + 1
        if fmeter is not None:
            qrow = None if q is None else q.cpu().numpy()
            qbits = 0
            if channel is not None and qrow is not None and quorum_ok:
                qbits = int(np.sum(qrow <= 0)) * payload
            fmeter.charge(None, qrow, quorum_ok,
                          ul_total if channel is not None else 0, qbits)

        out = {"params": stacked, "opt": opt_state}
        if lossy:
            out["ef"] = ef
        store.scatter(idx, placement.gather(out))

        if event % fl.eval_every == 0 or event == fl.rounds - 1:
            # cohort-local eval (the resident engine's full-population
            # eval in the lockstep anchor)
            mean_acc, worst_acc = placement.evaluate(acc_fn, stacked, sub)
            record_eval(history, event, mean_acc, worst_acc, t_done)

    if state is None:
        raise ValueError("fl.rounds must be >= 1 for the async runtime")
    history = finalize_history(history, strategy, state, keep_state,
                               _final_rows(store, "params"),
                               _final_rows(store, "opt"))
    history.extra["async"] = {"buffer_k": k_buf,
                              "max_staleness": cfg.max_staleness,
                              "staleness_schedule": cfg.staleness_schedule,
                              "staleness_discount": cfg.staleness_discount,
                              "staleness_alpha": cfg.staleness_alpha,
                              "max_retries": cfg.max_retries,
                              "retry_backoff": cfg.retry_backoff,
                              "events": fl.rounds}
    history.extra["paging"] = {
        "population": n, "cohort": k_buf, "schedule": "arrival-buffer",
        "store_bytes": int(store.nbytes),
        "store_dir": paging.store_dir, "chunks": fl.rounds,
        "resumed_at": None}
    if fmeter is not None:
        history.extra["faults"] = fmeter.extra()
    if channel is not None:
        channel_extra(history, channel, link, model_bits, payload)
        if keep_state and lossy:
            history.final_residual = _final_rows(store, "ef")
    return history
