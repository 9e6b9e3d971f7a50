"""Paper experiment walk-through on the PyTorch port: EMNIST-like
covariate + label shift, the scenario of Fig. 2b.

Counterpart of `examples/personalization_emnist.py`: run local training,
FedAvg, UCFL (k streams) and the oracle through the Strategy API, then
print the accuracy-vs-rounds table and the worst-user comparison (Table
I).  ``--participation 0.5`` samples half the clients a round;
``--placement mesh`` runs the same experiment on `MeshShardMap`, here a
one-rank group the placement starts in-process (NCCL on the card, gloo
on the CPU), mixing by ``--schedule``.  Runs on the card unless
``--device cpu`` is given: the mix on the Y = W Θ kernel, Δ on the Gram
kernel.

    PYTHONPATH=src python examples/personalization_emnist_torch.py \\
        [--rounds 24] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import numpy as np
import torch.distributed as dist

from repro_torch.data import scenario_covariate_shift
from repro_torch.device import resolve_device
from repro_torch.fl import (SYSTEMS, FLConfig, History, MeshShardMap,
                            UniformFraction, run_federated)

SPECS = ("local", "fedavg", "ucfl_k4", "oracle")


def default_case(rounds: int = 18, clients: int = 12, samples: int = 2400,
                 device="cuda"):
    """The reference's scenario and schedule: covariate shift (key 0),
    ``samples`` over ``clients``; 5 local steps of batch 32, an eval
    every ``rounds // 6`` rounds."""
    fed = scenario_covariate_shift(0, n=samples, m=clients, device=device)
    return fed, FLConfig(rounds=rounds, local_steps=5, batch_size=32,
                         eval_every=max(rounds // 6, 1))


def row(h: History, m: int) -> dict:
    """A run's numbers: its eval rounds and accuracies, the last round's
    streams and unicasts, the round time under each of `SYSTEMS`, and the
    last round's and the run's downlink bits (None without a channel)."""
    cost = h.comm[-1]
    bits = [c.dl_bits for c in h.comm_bits]
    return {"rounds": list(h.rounds), "mean_acc": list(h.mean_acc),
            "worst_acc": list(h.worst_acc), "n_streams": cost.n_streams,
            "n_unicasts": cost.n_unicasts,
            "times": [s.round_time(m, n_streams=cost.n_streams,
                                   n_unicasts=cost.n_unicasts)
                      for s in SYSTEMS.values()],
            "dl_round": bits[-1] if bits else None,
            "dl_total": sum(bits) if bits else None,
            "history": h}


def personalization(fed, fl: FLConfig, *, specs: Sequence[str] = SPECS,
                    sampler=None, placement=None,
                    draws: Optional[Callable] = None,
                    model_init: Optional[Callable] = None,
                    device="cuda") -> dict:
    """``{spec: row}`` of the sweep (`row` gives its numbers).  One
    ``placement`` serves every run of the sweep; ``draws`` is called once
    a run for its draws object (default: the engine's own),
    ``model_init`` as `run_federated`'s."""
    dev = resolve_device(device)
    return {spec: row(run_federated(
        spec, fed, fl=fl, sampler=sampler, placement=placement,
        model_init=model_init,
        draws=None if draws is None else draws(), device=dev), fed.m)
        for spec in specs}


def print_report(results: dict) -> None:
    """The reference script's lines."""
    for spec, r in results.items():
        print(f"{spec:10s} rounds={r['rounds']} mean_acc="
              f"{np.round(r['mean_acc'], 3).tolist()}")
    print("\nTable-I-style worst-user accuracy:")
    for spec, r in results.items():
        print(f"  {spec:10s} mean={r['mean_acc'][-1]:.3f} "
              f"worst={r['worst_acc'][-1]:.3f}")
    if "ucfl_k4" in results and "oracle" in results:
        uc, oa = results["ucfl_k4"], results["oracle"]
        print(f"\nUCFL k=4 reaches "
              f"{uc['mean_acc'][-1] / max(oa['mean_acc'][-1], 1e-9):.0%}"
              " of the oracle (4 true rotation groups).")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=18)
    p.add_argument("--clients", type=int, default=12)
    p.add_argument("--samples", type=int, default=2400)
    p.add_argument("--participation", type=float, default=1.0)
    p.add_argument("--placement", default="host", choices=("host", "mesh"))
    p.add_argument("--schedule", default="gspmd",
                   choices=("gspmd", "shard_map_streams",
                            "shard_map_unicast"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    fed, fl = default_case(args.rounds, args.clients, args.samples,
                           args.device)
    sampler = (UniformFraction(args.participation)
               if args.participation != 1.0 else None)
    started = args.placement == "mesh" and not dist.is_initialized()
    placement = (MeshShardMap(schedule=args.schedule, device=args.device)
                 if args.placement == "mesh" else None)
    try:
        results = personalization(fed, fl, sampler=sampler,
                                  placement=placement, device=args.device)
    finally:
        if started:             # the one-rank group the placement began
            dist.destroy_process_group()
    print_report(results)
    return results


if __name__ == "__main__":
    main()
