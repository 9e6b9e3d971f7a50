#!/usr/bin/env python3
"""The tensor-core flash kernel's 192-wide instances at two key tiles.

    python3 tools/tc_tile_ab.py

Builds two copies of `src/repro_torch/kernels/csrc/flash_attention_tc.cu`
under ``build/tc_tile_ab/``, one whose (192, 192) and (192, 128)
instances take 32-key K/V tiles and one whose take 64-key tiles (the
other instances as the source has them), prints ptxas's registers and
spills for those instances in each, and at each pair's served prefill
(nemotron-4-340b: B 2, 96 query heads on 8 KV heads of 192, S 4,064;
deepseek-v3-671b's MLA: B 2, 128 heads, dk 192, dv 128, S 4,064; causal,
bf16) holds the two copies' outputs within bf16's 3e-2 of each other and
times them in turns (A B B A, five rounds, the median CUDA-event ms of
each).  The source's own choice is printed beside them.  Needs an H100
and nvcc.
"""
from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

TILE = ("  static constexpr int kBK =\n"
        "      DK == 256 || DV == 256 || (DK == 192 && DV == 192) ? 32 : 64;")
# (label, B, H, Kh, S, dk, dv, mangled template arguments)
PAIRS = (("nemotron-4-340b prefill (192, 192)", 2, 96, 8, 4064, 192, 192,
          "Li192ELi192E"),
         ("deepseek-v3-671b MLA prefill (192, 128)", 2, 128, 128, 4064, 192,
          128, "Li192ELi128E"))


def build(keys: int) -> tuple:
    """(the copy's C entry, its ptxas log) with ``keys``-key tiles at
    both 192-wide instances."""
    src = (_build.CSRC / "flash_attention_tc.cu").read_text()
    if src.count(TILE) != 1:
        raise RuntimeError("the tile rule of flash_attention_tc.cu moved")
    src = src.replace(TILE, "  static constexpr int kBK = DK == 192 ? "
                      f"{keys} : (DK == 256 || DV == 256 ? 32 : 64);")
    out = _build.BUILD_DIR.parent / "tc_tile_ab"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"tc_bk{keys}.cu", out / f"tc_bk{keys}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(so)).repro_flash_attention_tc
    fn.argtypes = fa._ARGTYPES
    fn.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def instance_lines(log: str, mangled: str) -> list:
    """ptxas's register and spill lines for one pair's two instances."""
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if mangled in ln and "Compiling" in ln:
            out += [x.strip() for x in lines[i + 1:i + 4]
                    if "registers" in x or "spill" in x]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_tile_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    builds = {keys: build(keys) for keys in (32, 64)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = math.sqrt(0.25)
    entry = fa._entry
    for label, b, h, kh, s, dk, dv, mangled in PAIRS:
        uses = 32 if dk == dv == 192 else 64
        print(f"{label}: the source's tiles {uses} keys")
        for keys, (_, log) in builds.items():
            print(f"  ptxas at {keys}-key tiles:",
                  *instance_lines(log, mangled), sep="\n    ")
        q = (torch.randn((b, s, h, dk), generator=gen, device="cuda") * a
             ).to(torch.bfloat16).transpose(1, 2)
        k = (torch.randn((b, s, kh, dk), generator=gen, device="cuda") * a
             ).to(torch.bfloat16).transpose(1, 2)
        v = torch.randn((b, s, kh, dv), generator=gen, device="cuda"
                        ).to(torch.bfloat16).transpose(1, 2)

        def run(keys):
            fa._entry = lambda name: builds[keys][0]
            try:
                return fa.flash_attention_tc_cuda(q, k, v, causal=True)
            finally:
                fa._entry = entry

        y32, y64 = run(32), run(64)
        torch.cuda.synchronize()
        d = (y32.float() - y64.float()).abs()
        if not bool(torch.all(d <= 3e-2 + 3e-2 * y64.float().abs())):
            raise AssertionError(f"{label}: the two tilings disagree, max "
                                 f"|err| {float(d.max())}")
        times = {32: [], 64: []}
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        for _ in range(5):
            for keys in (32, 64, 64, 32):
                run(keys)
                start.record()
                for _ in range(5):
                    run(keys)
                stop.record()
                stop.synchronize()
                times[keys].append(start.elapsed_time(stop) / 5)
        flops = 2.0 * (dk + dv) * b * h * s * (s + 1) / 2
        for keys, ts in times.items():
            ms = statistics.median(ts)
            print(f"  {keys}-key tiles: median {ms:.4f} ms (min "
                  f"{min(ts):.4f}, max {max(ts):.4f}); "
                  f"{flops / ms / 1e9:.1f} TFLOP/s")
        print(f"  max |32 - 64| {float(d.max()):.3e} (bf16 tolerance 3e-2)")
        del q, k, v, y32, y64
    return 0


if __name__ == "__main__":
    sys.exit(main())
