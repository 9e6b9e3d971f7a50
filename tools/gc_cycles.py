#!/usr/bin/env python3
"""The tensors a paged federated run leaves in reference cycles: memory
that would stay held after the run returns until Python's cycle
collector next ran.  It prints 0 tensors for every run: the one cycle it
found (torch.func's first gradient importing torch._dynamo, whose import
kept the calling frames, and with them the first run's data pages,
alive) is gone since `repro_torch` imports torch._dynamo itself.

    PYTHONPATH=src python3 tools/gc_cycles.py [--device cpu] [--population N]

Runs `run_federated("ucfl_k4", ...)` under cohort paging (cohorts of 20,
qsgd:8 under wireless_slow, as `chip_smoke.py`'s [paging]) over a
label-shift population on the host, once with ``keep_state=True`` and
twice without, the collector off during each run.  After each it drops
the history, collects, and prints the objects found in cycles, the
tensors among them and their bytes, by device.  Runs on the card unless
``--device cpu`` is given.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
from collections import Counter

import torch

from repro_torch.data import FederatedData, scenario_label_shift
from repro_torch.fl import (SYSTEMS, Channel, FLConfig, PagingConfig,
                            run_federated)
from repro_torch.fl.simulator import default_model_init


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--population", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    m = args.population
    made = scenario_label_shift(0, n=100 * m, m=m, device=args.device)
    fed = FederatedData(*(t.cpu() for t in made))
    del made
    kw = dict(fl=FLConfig(rounds=args.rounds, local_steps=5, batch_size=32,
                          eval_every=1),
              system=SYSTEMS["wireless_slow"], channel=Channel(codec="qsgd:8"),
              model_init=default_model_init(fed), seed=0, device=args.device)
    for keep in (True, False, False):
        gc.collect()
        gc.disable()
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            h = run_federated("ucfl_k4", fed, keep_state=keep,
                              paging=PagingConfig(cohort=20), **kw)
            if args.device != "cpu":
                torch.cuda.synchronize()
            del h
            gc.collect()
            ts = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
            by_dev, seen = Counter(), set()
            for t in ts:
                try:
                    st = t.untyped_storage()
                except NotImplementedError:   # a functorch wrapper
                    continue
                if (t.device, st.data_ptr()) not in seen:
                    seen.add((t.device, st.data_ptr()))
                    by_dev[t.device.type] += st.nbytes()
            print(f"keep_state={keep}: {len(gc.garbage)} objects in cycles, "
                  f"{len(ts)} tensors, bytes by device {dict(by_dev)}",
                  flush=True)
        finally:
            gc.garbage.clear()
            gc.set_debug(0)
            gc.enable()


if __name__ == "__main__":
    main()
