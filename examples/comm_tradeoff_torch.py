"""Communication/learning trade-off on the PyTorch port (paper §III-B,
Fig. 3).

Counterpart of `examples/comm_tradeoff.py`: sweep the number of
personalised streams and print accuracy and the two communication axes,
wall-clock time under the three system models (the paper's T_dl units)
and cumulative downlink bits from the channel, then the same ucfl_k2
point through the lossy codecs, then the silhouette guidance for picking
m_t.  Each sweep point is a registered Strategy; the per-round downlink
cost comes from the run's own `History.comm` / `History.comm_bits`.  The
identity codec's channel is bit-exact with the channel-less engine, so
attaching it only adds the bits axis.  Runs on the card unless
``--device cpu`` is given: the mix on the Y = W Θ kernel, Δ on the Gram
kernel, the qsgd crossings on the QSGD row pass and the top-k crossing
on the threshold kernel.

    PYTHONPATH=src python examples/comm_tradeoff_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import kmeans, silhouette_score
from repro_torch.data import scenario_covariate_shift
from repro_torch.device import resolve_device
from repro_torch.fl import SYSTEMS, Channel, FLConfig, History, run_federated

# (spec, streams column); None: one stream a client
SPECS = (("fedavg", 1), ("ucfl_k2", 2), ("ucfl_k4", 4), ("ucfl", None))
CODECS = ("identity", "qsgd:8", "qsgd:4", "topk:0.25")
CODEC_SPEC = "ucfl_k2"          # the point the codec block re-runs
KS = (2, 3, 4, 6)


def default_case(device="cuda"):
    """The reference's scenario and schedule: covariate shift (key 1), n
    2,000 over m 12 clients; 12 rounds of 5 local steps of batch 32, an
    eval every 11."""
    fed = scenario_covariate_shift(1, n=2000, m=12, device=device)
    return fed, FLConfig(rounds=12, local_steps=5, batch_size=32,
                         eval_every=11)


def row(h: History, m: int) -> dict:
    """A run's columns: the last round's streams and unicasts, the last
    eval's accuracies, the round time under each of `SYSTEMS`, the last
    round's and the run's downlink bits."""
    cost = h.comm[-1]
    return {"n_streams": cost.n_streams, "n_unicasts": cost.n_unicasts,
            "mean_acc": h.mean_acc[-1], "worst_acc": h.worst_acc[-1],
            "times": [s.round_time(m, n_streams=cost.n_streams,
                                   n_unicasts=cost.n_unicasts)
                      for s in SYSTEMS.values()],
            "dl_round": h.comm_bits[-1].dl_bits,
            "dl_total": sum(c.dl_bits for c in h.comm_bits),
            "history": h}


def tradeoff(fed, fl: FLConfig, *, specs: Sequence = SPECS,
             codecs: Sequence[str] = CODECS, ks: Sequence[int] = KS,
             draws: Optional[Callable] = None,
             model_init: Optional[Callable] = None,
             first: Optional[int] = None, device="cuda") -> dict:
    """The sweep's numbers: ``{"m", "streams": {spec: row}, "codecs":
    {codec: row}, "silhouette": {k: float}}`` (`row` gives a row's
    columns).  ``specs`` are (spec, streams column) pairs and hold
    `CODEC_SPEC`; each codec of ``codecs`` re-runs `CODEC_SPEC` (its
    identity row is the stream sweep's run).  ``draws`` is called once a
    run for its draws object (default: the engine's own), ``model_init``
    as `run_federated`'s; ``first`` is the silhouette block's k-means
    first centre (default drawn from a generator seeded 1, the
    reference's key there).  The silhouettes are over W of the
    `CODEC_SPEC` run: every ucfl-family setup computes the same W at the
    same params0, so it is the W the reference reads off its ucfl run."""
    dev = resolve_device(device)
    m = fed.m

    def run(spec, channel):
        return run_federated(spec, fed, fl=fl, channel=channel,
                             model_init=model_init,
                             draws=None if draws is None else draws(),
                             device=dev)

    streams = {spec: row(run(spec, Channel()), m) for spec, _ in specs}
    coded = {}
    for codec in codecs:
        if codec == "identity":
            coded[codec] = streams[CODEC_SPEC]
        else:
            coded[codec] = row(run(CODEC_SPEC, Channel(codec=codec)), m)

    w = torch.as_tensor(
        streams[CODEC_SPEC]["history"].extras.mixing_matrix, device=dev)
    if first is None:
        gen = torch.Generator().manual_seed(1)
        first = int(torch.randint(0, m, (), generator=gen))
    sil = {}
    for k in ks:
        plan = kmeans(w, k, first=first)
        sil[k] = float(silhouette_score(w, plan.assignment, k))
    return {"m": m, "streams": streams, "codecs": coded, "silhouette": sil}


def print_report(r: dict, specs: Sequence = SPECS) -> None:
    """The reference script's table, row for row."""
    m = r["m"]
    print("streams  mean_acc  worst_acc   t/round (slow-UL, fast-UL, wired)"
          "   DL Mbit/round  cum DL Mbit")
    for spec, k in specs:
        x = r["streams"][spec]
        print(f"{m if k is None else k:7d}  {x['mean_acc']:.3f}     "
              f"{x['worst_acc']:.3f}     "
              + "  ".join(f"{t:5.1f}" for t in x["times"])
              + f"        {x['dl_round']/1e6:8.2f}     "
              f"{x['dl_total']/1e6:8.2f}")
    print(f"\n{CODEC_SPEC} under uplink compression (error feedback on):")
    print("codec      mean_acc  worst_acc  DL Mbit/round  cum DL Mbit")
    for codec, x in r["codecs"].items():
        print(f"{codec:10s} {x['mean_acc']:.3f}     {x['worst_acc']:.3f}"
              f"      {x['dl_round']/1e6:8.2f}     {x['dl_total']/1e6:8.2f}")
    print("\nsilhouette score by k (pick the max):")
    for k, s in r["silhouette"].items():
        print(f"  k={k}: {s:.3f}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fed, fl = default_case(args.device)
    r = tradeoff(fed, fl, device=args.device)
    print_report(r)
    return r


if __name__ == "__main__":
    main()
