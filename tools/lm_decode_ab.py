#!/usr/bin/env python3
"""`chip_smoke.py`'s [lm] (a) decode, timed for checkouts of the port in
turns, on one NVIDIA card.

    python3 tools/lm_decode_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (this checkout's is
``src``; another's is unpacked under a directory that .gitignore lists).
Each runs in a process of its own, which builds that checkout's kernels
and times its `launch.serve.generate` at [lm] (a)'s configuration:
gemma2-27b at full width, depth 46 -> 2, bf16, random weights from seed
0, B 2, a 4,608-token prompt, 32 greedy tokens, cache 4,640.  After a
warm-up, three timed runs: prefill ms, decode ms a token step and tok/s
of each.  Prints the card line, then one JSON line a SRC.  Imports
nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

LM = dict(arch="gemma2-27b", batch=2, prompt=4608, tokens=32,
          cache_len=4640, seed=0, runs=3)


def child(src: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    cfg = dataclasses.replace(get_config(LM["arch"]), n_layers=2)
    params = T.init_params(torch.Generator(device="cuda")
                           .manual_seed(LM["seed"]), cfg, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (LM["batch"], LM["prompt"]),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(LM["seed"] + 1))
    generate(params, cfg, prompt[:, :64], 2, 128)             # warm-up
    generate(params, cfg, prompt, LM["tokens"], LM["cache_len"])
    steps = LM["tokens"] - 1
    runs = []
    for _ in range(LM["runs"]):
        res = generate(params, cfg, prompt, LM["tokens"], LM["cache_len"])
        runs.append({"prefill_ms": res.prefill_s * 1e3,
                     "decode_ms_a_step": res.decode_s * 1e3 / steps,
                     "tok_s": steps * LM["batch"] / res.decode_s})
    print(json.dumps({"src": src, "runs": runs}), flush=True)


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
