"""Federated LM training CLI — a thin shell over the round engine.

Counterpart of `repro/launch/train.py`.  One command drives the paper's
pipeline on a language model: the registry resolves ``--algorithm`` to a
`Strategy` (similarity pre-round, Eq. 6 mixing, k-means streams all live
in `UCFL.setup`), and `run_federated` runs the rounds under a
`MeshShardMap` placement (the default: one process a rank; started alone
it is a one-rank group) or `HostVmap`.  Every registered strategy, the
sampler, the channel, the async runtime, cohort paging, the hierarchy
tier, faults and defenses run here exactly as in the LeNet engine:

    python -m repro_torch.launch.train --arch stablelm-3b \\
        --preset cpu-small --steps 20 --algorithm ucfl_k2 --clients 4 \\
        [--device cpu]

The model's params ride in the engine as the flat-key view of the
reference's scanned layout (`models.scan.flat_params`), so the engine's
rows line up with the reference's leaf for leaf; the loss re-nests them.
``--async [--buffer-k K --max-staleness TAU --staleness-discount L]``
switches to the buffered-async runtime: ``--steps`` then counts
aggregation events and the reported time is the event-driven virtual
clock.

Presets: cpu-small (~5M params), lm-100m (the deliverable-scale run: 8
layers, d_model 512, d_ff 2,048, vocab 32,000), full (the assigned
config).  The token data, the initial params and the run's draws
(minibatches, the k-means start, codec noise, faults) come from host
generators seeded by ``--seed`` and move to ``--device`` (default
``cuda``), so a run on the card and one on the CPU see the same bits.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.checkpoint import save_train_state
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data.federated import FederatedData
from repro_torch.data.synthetic import synthetic_lm_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl import (AsyncConfig, Channel, FLConfig, HierarchyConfig,
                            HostVmap, MeshShardMap, PagingConfig, SYSTEMS,
                            TorchDraws, UniformFraction, get_strategy,
                            run_federated)
from repro_torch.launch.steps import _loss_fn, init_model_params
from repro_torch.models.scan import flat_params, nest_params


def preset_config(arch: str, preset: str) -> ModelConfig:
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "lm-100m":
        # ~100M params in the same family
        cfg = reduced(cfg, n_layers=8, d_model=512, vocab=32000, max_seq=1024)
        return dataclasses.replace(cfg, n_layers=8, d_ff=2048)
    return reduced(cfg, n_layers=2, d_model=256, vocab=512, max_seq=256)


def lm_fns(cfg: ModelConfig):
    """(loss_fn, acc_fn) of the engine over the flat-key view: the token
    batch rides in the ``x`` slot; the score is −CE (higher is better).
    A vlm config trains on the tokens alone, as the reference's does.
    The audio family raises `KeyError`: its loss needs the batch's
    ``audio_embeds``, which the LM clients' data does not carry (the
    reference's loss raises the same `KeyError` at its first call)."""
    if cfg.family == "audio":
        raise KeyError(f"audio_embeds: {cfg.name}'s loss needs audio "
                       "frames, and the federated LM data holds tokens only")
    lm_loss = _loss_fn(cfg, remat=False)
    loss_fn = lambda p_, b: lm_loss(nest_params(p_),  # noqa: E731
                                    {"tokens": b["x"]})
    acc_fn = lambda p_, b: -lm_loss(nest_params(p_),  # noqa: E731
                                    {"tokens": b["x"]})[0]
    return loss_fn, acc_fn


@functools.lru_cache(maxsize=8)
def _lm_fns(arch: str, preset: str):
    """(cfg, loss_fn, acc_fn) memoized per (arch, preset): stable function
    identities let the engine's cached update step and superstep serve
    repeated main() calls."""
    cfg = preset_config(arch, preset)
    return (cfg, *lm_fns(cfg))


def host_generator(key: int, *parts: int) -> torch.Generator:
    """A CPU generator seeded by (``key``, ``parts``): one independent
    stream per draw site, the same bits whatever the run's device."""
    seed = np.random.SeedSequence([int(key), *parts]).generate_state(
        1, np.uint64)[0] >> np.uint64(1)
    return torch.Generator().manual_seed(int(seed))


def lm_federated_data(key: int, m: int, *, pool: int, n_val: int, seq: int,
                      vocab: int, n_groups: int = 2,
                      device: DeviceLike = "cuda") -> FederatedData:
    """Heterogeneous LM clients as a stacked `FederatedData`: client i of
    group ``i % n_groups`` draws its own Markov rule (train and
    validation each their own, as the reference's keys give them),
    from host generators seeded by (``key``, group, i).  Tokens ride in
    the ``x`` slot ((m, n, seq) int64); ``y`` is a dummy — the LM loss
    reads only ``batch["x"]``."""
    dev = resolve_device(device)
    groups = np.arange(m) % n_groups
    xs, xv = [], []
    for i in range(m):
        g = int(groups[i])
        xs.append(synthetic_lm_tokens(host_generator(key, g, i), pool, seq,
                                      vocab))
        xv.append(synthetic_lm_tokens(host_generator(key, g, i, 999), n_val,
                                      seq, vocab))
    zeros = lambda n: torch.zeros((m, n), dtype=torch.int64)  # noqa: E731
    return FederatedData(
        x=torch.stack(xs).to(dev), y=zeros(pool).to(dev),
        n=torch.full((m,), float(pool), device=dev),
        x_val=torch.stack(xv).to(dev), y_val=zeros(n_val).to(dev),
        group=torch.as_tensor(groups, dtype=torch.int64, device=dev))


def lm_model_init(cfg: ModelConfig, dev: torch.device):
    """``model_init`` of an LM run: the flat-key view of
    `init_model_params`, drawn on the host from the engine's generator's
    seed and moved to ``dev``."""
    def init(gen: torch.Generator) -> Dict[str, torch.Tensor]:
        host = torch.Generator().manual_seed(gen.initial_seed())
        flat = flat_params(init_model_params(host, cfg))
        return {k: v.to(dev) for k, v in flat.items()}
    return init


def save_checkpoint(path: str, step: int, history, cfg: ModelConfig,
                    spec: str) -> None:
    """``save_train_state`` of a run kept with ``keep_state``, its params
    and optimizer state in the reference's scanned layout (the same file
    as the reference's on the same values)."""
    opt = dict(history.final_opt_state)
    if opt.get("mu") is not None:
        opt["mu"] = nest_params(opt["mu"])
    save_train_state(path, step, nest_params(history.final_params),
                     opt, extra={"arch": cfg.name, "algorithm": spec})


def _fleet_arg(spec: str):
    """``"3"`` -> 3; anything else passes through as a fleet spec string
    (``uniform:<D>`` | ``ragged:<min>-<max>``)."""
    try:
        return int(spec)
    except ValueError:
        return spec


def _validate_specs(p, args):
    """Registry-backed spec validation at parse time: a typo dies as a
    one-line argparse error naming the registry's options instead of a
    traceback from the middle of engine init."""
    from repro_torch.fl.channel import get_codec, get_link_profile
    from repro_torch.fl.faults import get_robust_aggregator, parse_fault_spec
    from repro_torch.fl.hierarchy import (get_edge_aggregator,
                                          resolve_fleet_spec)
    for flag, spec in (("--codec", args.codec),
                       ("--edge-codec", args.edge_codec)):
        if spec is not None:
            try:
                get_codec(spec)
            except ValueError as e:
                p.error(f"{flag}: {e}")
    for flag, spec in (("--link-profile", args.link_profile),
                       ("--edge-link", args.edge_link)):
        if spec is not None:
            try:
                get_link_profile(spec, SYSTEMS["wired"], 32, 2)
            except ValueError as e:
                p.error(f"{flag}: {e}")
    if args.cohort_schedule not in ("sweep", "random"):
        p.error(f"--cohort-schedule: unknown cohort schedule "
                f"{args.cohort_schedule!r}; options: ['sweep', 'random']")
    if args.edge_aggregator is not None:
        try:
            get_edge_aggregator(args.edge_aggregator)
        except ValueError as e:
            p.error(f"--edge-aggregator: {e}")
    if args.devices_per_user is not None:
        try:
            resolve_fleet_spec(_fleet_arg(args.devices_per_user), 2,
                               seed=args.seed)
        except (TypeError, ValueError) as e:
            p.error(f"--devices-per-user: {e}")
    if args.faults is not None:
        try:
            parse_fault_spec(args.faults)
        except ValueError as e:
            p.error(f"--faults: {e}")
    if args.robust_agg is not None:
        try:
            get_robust_aggregator(args.robust_agg)
        except ValueError as e:
            p.error(f"--robust-agg: {e}")
    if args.min_quorum is not None and args.min_quorum < 1:
        p.error(f"--min-quorum: must be >= 1, got {args.min_quorum}")
    if args.max_retries < 0:
        p.error(f"--max-retries: must be >= 0, got {args.max_retries}")
    if args.retry_backoff <= 0:
        p.error(f"--retry-backoff: must be > 0, got {args.retry_backoff}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="stablelm-3b")
    p.add_argument("--preset", default="cpu-small",
                   choices=("cpu-small", "lm-100m", "full"))
    p.add_argument("--steps", type=int, default=20,
                   help="federated rounds")
    p.add_argument("--local-steps", type=int, default=1,
                   help="client SGD steps per round")
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--pool", type=int, default=32,
                   help="sequences per client dataset")
    p.add_argument("--algorithm", default="ucfl_k2",
                   help="any registry spec: fedavg | local | oracle | ucfl "
                        "| ucfl_k<k> | cfl | fedfomo")
    p.add_argument("--placement", default="mesh", choices=("mesh", "host"))
    p.add_argument("--schedule", default="gspmd",
                   choices=("gspmd", "shard_map_streams",
                            "shard_map_unicast"))
    p.add_argument("--participation", type=float, default=1.0,
                   help="per-round client fraction (UniformFraction)")
    p.add_argument("--async", dest="run_async", action="store_true",
                   help="buffered-async runtime: event-driven virtual "
                        "clock instead of sync rounds")
    p.add_argument("--buffer-k", type=int, default=2,
                   help="async: aggregate once this many uploads buffer")
    p.add_argument("--max-staleness", type=float, default=None,
                   help="async: drop updates older than this many server "
                        "versions (default: keep all)")
    p.add_argument("--staleness-discount", type=float, default=0.9,
                   help="async: λ of the exp-schedule λ**age discount")
    p.add_argument("--staleness-schedule", default="exp",
                   choices=("exp", "poly"),
                   help="async: contributor discount law — FedBuff-style "
                        "exp (λ**age) or FedAsync poly ((1+age)**-α)")
    p.add_argument("--staleness-alpha", type=float, default=0.5,
                   help="async: α of the poly staleness schedule")
    p.add_argument("--codec", default=None,
                   help="uplink channel codec: identity | qsgd:<bits> | "
                        "topk:<frac>; enables bit-level payload accounting")
    p.add_argument("--link-profile", default=None,
                   help="per-client link rates: uniform | tiered:<factor> "
                        "| lognormal:<sigma> (implies a channel)")
    p.add_argument("--error-feedback", dest="error_feedback",
                   action="store_true", default=True,
                   help="carry per-client codec residuals (default on)")
    p.add_argument("--no-error-feedback", dest="error_feedback",
                   action="store_false")
    p.add_argument("--system", default="wired", choices=tuple(SYSTEMS),
                   help="analytic clock (paper §IV-C); in --async mode "
                        "also the virtual clock's arrival law")
    p.add_argument("--eval-every", type=int, default=5)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--cohort", type=int, default=None,
                   help="cohort paging: keep only this many of --clients "
                        "on the device per superstep, the rest in the "
                        "host-backed store")
    p.add_argument("--cohort-schedule", default="sweep",
                   help="paging: which cohort each superstep trains "
                        "(sweep | random; validated at parse)")
    p.add_argument("--store-dir", default=None,
                   help="paging: disk-back the client-state store (.npy "
                        "memmaps) instead of host RAM")
    p.add_argument("--checkpoint-dir", default=None,
                   help="paging: write superstep-boundary snapshots here "
                        "(store rows + engine carry + history)")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="paging: snapshot cadence in supersteps")
    p.add_argument("--resume", action="store_true",
                   help="paging: resume from the latest snapshot in "
                        "--checkpoint-dir")
    p.add_argument("--devices-per-user", default=None,
                   help="hierarchy tier: per-user device fleet spec — an "
                        "int, uniform:<D>, or ragged:<min>-<max>; enables "
                        "the edge sub-round")
    p.add_argument("--edge-codec", default="identity",
                   help="hierarchy: device->user uplink codec (same "
                        "registry as --codec)")
    p.add_argument("--edge-link", default=None,
                   help="hierarchy: per-device link profile (same "
                        "families as --link-profile)")
    p.add_argument("--edge-aggregator", default="mean",
                   help="hierarchy: edge aggregation rule — mean | "
                        "drop_stragglers:<frac>")
    p.add_argument("--edge-latency", type=float, default=0.0,
                   help="hierarchy: fixed per-sub-round edge latency "
                        "charged to every user's clock")
    p.add_argument("--device-dropout", type=float, default=0.0,
                   help="hierarchy: per-round probability each device "
                        "misses its edge sub-round")
    p.add_argument("--faults", default=None,
                   help="fault injection: comma-joined crash:<p> | nan:<p> "
                        "| byz:<frac>[:<mode>[:<scale>]] | "
                        "bitrot:<p>[:<density>] | seed:<int>")
    p.add_argument("--robust-agg", dest="robust_agg", default=None,
                   help="defense: none | clip:<c> | trimmed_mean:<f> | "
                        "median | krum:<f>; screens non-finite uploads and "
                        "quarantines outliers")
    p.add_argument("--min-quorum", type=int, default=None,
                   help="skip aggregation on rounds with fewer than this "
                        "many participating clients (server state carries "
                        "forward; uploads are wasted)")
    p.add_argument("--max-retries", type=int, default=3,
                   help="async+crash faults: consecutive crashes before a "
                        "client is dead for the run")
    p.add_argument("--retry-backoff", type=float, default=1.0,
                   help="async+crash faults: base of the backoff*2**attempt"
                        " reschedule delay")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the run goes: cuda (default) or cpu")
    return p


def main(argv=None):
    p = _parser()
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1")
    _validate_specs(p, args)

    # registry-validated spec: bad specs raise ValueError before any work
    strategy = get_strategy(args.algorithm)
    cfg, loss_fn, acc_fn = _lm_fns(args.arch, args.preset)
    dev = resolve_device(args.device)
    m = args.clients

    fed = lm_federated_data(args.seed, m, pool=args.pool,
                            n_val=max(4, args.batch), seq=args.seq,
                            vocab=cfg.vocab_size, device=dev)
    placement = (MeshShardMap(schedule=args.schedule, device=dev)
                 if args.placement == "mesh" else HostVmap())
    # the paper's optimizer (SGD η=.1 β=.9); giants drop momentum and keep
    # state in the param dtype (steps.make_optimizer's policy)
    pod = cfg.fl_client_axis == "pod"
    fl = FLConfig(rounds=args.steps, local_steps=args.local_steps,
                  batch_size=args.batch, eval_every=args.eval_every,
                  momentum=0.0 if pod else 0.9,
                  opt_state_dtype=None if pod else "param")
    async_cfg = None
    if args.run_async:
        if args.participation < 1.0:
            p.error("--participation is a sync-only knob: the async "
                    "arrival buffer is the per-event cohort")
        async_cfg = AsyncConfig(buffer_k=args.buffer_k,
                                max_staleness=args.max_staleness,
                                staleness_schedule=args.staleness_schedule,
                                staleness_discount=args.staleness_discount,
                                staleness_alpha=args.staleness_alpha,
                                max_retries=args.max_retries,
                                retry_backoff=args.retry_backoff)
    sampler = (UniformFraction(args.participation)
               if args.participation < 1.0 else None)
    paging = None
    if args.cohort is not None:
        if args.cohort > m:
            p.error(f"--cohort {args.cohort} > --clients {m}")
        paging = PagingConfig(cohort=args.cohort,
                              schedule=args.cohort_schedule,
                              schedule_seed=args.seed,
                              store_dir=args.store_dir,
                              checkpoint_dir=args.checkpoint_dir,
                              checkpoint_every=args.checkpoint_every,
                              resume=args.resume)
    channel = None
    if args.codec is not None or args.link_profile is not None:
        channel = Channel(codec=args.codec or "identity",
                          link=args.link_profile,
                          error_feedback=args.error_feedback)
    hierarchy = None
    if args.devices_per_user is not None:
        hierarchy = HierarchyConfig(
            devices_per_user=_fleet_arg(args.devices_per_user),
            edge_codec=args.edge_codec,
            edge_aggregator=args.edge_aggregator,
            edge_link=args.edge_link,
            edge_latency=args.edge_latency,
            device_dropout=args.device_dropout,
            seed=args.seed)

    print(f"arch={cfg.name} preset={args.preset} clients={m} "
          f"alg={strategy.spec} placement={placement!r} device={dev}"
          + (f" async={async_cfg}" if async_cfg else "")
          + (f" paging={paging}" if paging else "")
          + (f" channel={channel}" if channel else "")
          + (f" hierarchy={hierarchy}" if hierarchy else "")
          + (f" faults={args.faults}" if args.faults else "")
          + (f" robust_agg={args.robust_agg}" if args.robust_agg else "")
          + (f" min_quorum={args.min_quorum}" if args.min_quorum else ""))
    init = lm_model_init(cfg, dev)
    n_params = []

    def model_init(gen):
        params = init(gen)
        n_params.append(sum(v.numel() for v in params.values()))
        return params

    t0 = time.time()
    history = run_federated(
        strategy=strategy, fed=fed, fl=fl, sampler=sampler,
        model_init=model_init, loss_fn=loss_fn, acc_fn=acc_fn,
        system=SYSTEMS[args.system], placement=placement, channel=channel,
        keep_state=bool(args.checkpoint), async_cfg=async_cfg,
        paging=paging, hierarchy=hierarchy, faults=args.faults,
        robust_agg=args.robust_agg, min_quorum=args.min_quorum,
        seed=args.seed, draws=TorchDraws(args.seed, "cpu"), device=dev)
    if paging is not None:
        pg = history.extra["paging"]
        print(f"paging: population={pg['population']} cohort={pg['cohort']} "
              f"schedule={pg['schedule']} "
              f"store={pg['store_bytes']/2**20:.1f} MiB"
              + (f" (resumed at superstep {pg['resumed_at']})"
                 if pg["resumed_at"] else ""))

    if n_params:
        print(f"params/model: {n_params[0]/1e6:.1f}M")
    if "mixing_matrix" in history.extra:
        print("mixing matrix rows:\n",
              np.round(np.asarray(history.extra["mixing_matrix"]), 3))
        print("(true groups:", fed.group.cpu().numpy(), ")")
    for rnd, mean_s, worst_s, t in zip(history.rounds, history.mean_acc,
                                       history.worst_acc, history.time):
        print(f"round {rnd:4d} loss/mean={-mean_s:.4f} "
              f"loss/worst={-worst_s:.4f} t_sys={t:.1f} "
              f"({time.time()-t0:.0f}s)")
    streams = sum(c.n_streams for c in history.comm)
    unicasts = sum(c.n_unicasts for c in history.comm)
    print(f"downlink total: {streams} streams, {unicasts} unicasts "
          f"({args.system})")
    if channel is not None:
        ch = history.extra["channel"]
        print(f"channel: codec={ch['codec']} link={ch['link']} "
              f"payload={ch['payload_bits']/1e6:.2f} Mbit "
              f"(model {ch['model_bits']/1e6:.2f} Mbit) | "
              f"downlink {ch['dl_bits_total']/1e6:.1f} Mbit, "
              f"uplink {ch['ul_bits_total']/1e6:.1f} Mbit")
    if hierarchy is not None:
        hx = history.extra["hierarchy"]
        print(f"hierarchy: fleets={hx['devices_per_user']} "
              f"edge_codec={hx['edge_codec']} "
              f"agg={hx['edge_aggregator']} link={hx['edge_link']} | "
              f"edge downlink {hx['edge_dl_bits_total']/1e6:.1f} Mbit, "
              f"edge uplink {hx['edge_ul_bits_total']/1e6:.1f} Mbit")
    if "faults" in history.extra:
        fx = history.extra["faults"]
        print(f"faults: spec={fx['faults']} robust_agg={fx['robust_agg']} "
              f"byzantine={fx['byzantine_clients']} "
              f"min_quorum={fx['min_quorum']} | "
              f"crashed {fx['crashed_total']}, "
              f"quarantined {fx['quarantined_total']}, "
              f"skipped rounds {fx['skipped_rounds']}, "
              f"retries {fx['retries']}, dead {fx['dead_clients']}, "
              f"wasted uplink {fx['wasted_ul_bits']/1e6:.2f} Mbit")

    if args.checkpoint:
        save_checkpoint(args.checkpoint, args.steps, history, cfg,
                        strategy.spec)
        print("checkpoint written:", args.checkpoint)
    return -history.mean_acc[-1]


if __name__ == "__main__":
    main()
