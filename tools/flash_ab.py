#!/usr/bin/env python3
"""The three flash-attention kernels at `chip_smoke.py`'s [lm] shapes,
timed for checkouts of the port in turns, on one NVIDIA card.

    python3 tools/flash_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (this checkout's is
``src``; another's is unpacked under a directory that .gitignore lists).
Each runs in a process of its own, which builds that checkout's kernels
and times `kernels.ops.flash_attention` on the same seeded inputs, each
call on its route's kernel: gemma2-27b's global layer (B 2, H 32, Kh 16,
hd 128, causal, softcap 50) as a bf16 prefill of 4,608 (the tensor-core
kernel), an f32 prefill of 4,608 (the CUDA-core kernel) and a bf16
decode step over 4,609 keys (the decode kernel), and gemma-2b's bf16
prefill (H 8, Kh 1, hd 256, S 8,160; the tensor-core kernel).  A time is
the median of 30 CUDA-event runs, the 50 MB L2 flushed before each.
Prints the card line, then one JSON line a SRC.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (name, B, H, Kh, Sq, Sk, hd, dtype, keyword arguments)
SHAPES = (
    ("tc prefill hd 128", 2, 32, 16, 4608, 4608, 128, "bfloat16",
     dict(causal=True, softcap=50.0)),
    ("cuda-core prefill hd 128 f32", 2, 32, 16, 4608, 4608, 128, "float32",
     dict(causal=True, softcap=50.0)),
    ("decode step hd 128", 2, 32, 16, 1, 4609, 128, "bfloat16",
     dict(causal=True, softcap=50.0)),
    ("tc prefill hd 256", 2, 8, 1, 8160, 8160, 256, "bfloat16",
     dict(causal=True)),
)


def child(src: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import _build, ops
    _build.build_all()
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def time_ms(fn, iters=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    out = {}
    for name, b, h, kh, sq, sk, hd, dt, kw in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(sq + hd)
        dtype = getattr(torch, dt)
        q = (torch.randn((b, sq, h, hd), generator=gen, device="cuda") * 0.5
             ).to(dtype).transpose(1, 2)
        k = (torch.randn((b, sk, kh, hd), generator=gen, device="cuda") * 0.5
             ).to(dtype).transpose(1, 2)
        v = torch.randn((b, sk, kh, hd), generator=gen, device="cuda"
                        ).to(dtype).transpose(1, 2)
        out[name] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        del q, k, v
    print(json.dumps({"src": src, "ms": out}), flush=True)


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
