#!/usr/bin/env python3
"""`chip_smoke.py`'s [paging] (b) sweep and (d) peak, timed for checkouts
of the port in turns, on one NVIDIA card.

    python3 tools/paging_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (this checkout's is
``src``; another's is unpacked under a directory that .gitignore lists).
Each runs in a process of its own, which builds that checkout's kernels,
makes the label-shift population of 1,000 clients over 100,000 samples
on the host (seed 0), runs one paged sweep to capture the superstep, and
then times 20 supersteps of ucfl_k4 + qsgd:8 under wireless_slow,
cohorts of 20, with prefetch on and off, three runs each, interleaved.
It also reads the requested-bytes peak of a sweep (prefetch on, without
keep_state) over 200, 1,000, 200 and 1,000 clients, each over the bytes
held before it, with the allocator's trace on: the blocks the program
had dropped but the allocator had not yet freed at the trace's peak
(its count and bytes).  Prints the card line, then one JSON line a SRC:
the s/superstep of each run and, for each peak sweep, [clients, peak
over the base, dropped-not-freed blocks, their bytes].  Imports nothing
of JAX.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path


def child(src: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    import numpy as np
    import torch
    from repro_torch.data import FederatedData, scenario_label_shift
    from repro_torch.fl import (SYSTEMS, Channel, FLConfig, PagingConfig,
                                run_federated, sub_federated)
    from repro_torch.fl.simulator import default_model_init
    from repro_torch.kernels import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    made = scenario_label_shift(0, n=100_000, m=1000, device="cuda")
    fed = FederatedData(*(t.cpu() for t in made))
    del made
    torch.cuda.empty_cache()
    rounds = 20
    kw = dict(fl=FLConfig(rounds=rounds, local_steps=10, batch_size=64,
                          eval_every=1),
              system=SYSTEMS["wireless_slow"], channel=Channel(codec="qsgd:8"),
              model_init=default_model_init(fed), seed=0, device="cuda")

    def sweep(f, prefetch, keep_state=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_federated("ucfl_k4", f, keep_state=keep_state,
                      paging=PagingConfig(cohort=20, prefetch=prefetch), **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / rounds

    sweep(fed, True)                       # the capture
    walls = {"prefetch": [], "no_prefetch": []}
    for _ in range(3):
        walls["prefetch"].append(sweep(fed, True))
        walls["no_prefetch"].append(sweep(fed, False))
    peaks = []
    for m in (200, 1000, 200, 1000):
        f = fed if m == fed.m else sub_federated(fed, np.arange(m))
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=1_000_000)
        sweep(f, True, keep_state=False)
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
        peaks.append([m, peak - base, *_dropped_at_peak(trace)])
    print(json.dumps({"src": src, "s_per_superstep": walls,
                      "peaks": peaks}), flush=True)


def _dropped_at_peak(trace) -> tuple:
    """(count, bytes) of the blocks dropped by the program but not yet
    freed by the allocator at the trace's peak of live bytes."""
    size, live, top, at = {}, 0, -1, 0
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            size[e["addr"]] = e["size"]
            live += e["size"]
        elif e["action"] == "free_completed":
            live -= size.pop(e["addr"], 0)
        if live > top:
            top, at = live, i
    dropped = {}
    for e in trace[:at + 1]:
        if e["action"] == "free_requested":
            dropped[e["addr"]] = e["size"]
        elif e["action"] in ("free_completed", "alloc"):
            dropped.pop(e["addr"], None)
    return len(dropped), sum(dropped.values())


def main(srcs) -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for src in srcs:
        subprocess.run([sys.executable, __file__, "--child", src],
                       check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
