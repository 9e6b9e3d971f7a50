#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   — needs CUDA; prints the card's name and power limit, turns
                TF32 off for matmul and cuDNN;
  2. build    — compiles every ``src/repro_torch/kernels/csrc/*.cu`` with
                nvcc (all at once) and prints build time and ptxas output;
  3. kernels  — holds each CUDA kernel against its plain PyTorch version on
                the card (tolerances of tests/test_kernels.py) and times
                kernel, plain version and one torch.matmul yardstick with
                CUDA events, beside the byte/FLOP bound;
  4. agree    — a small label-shift run on the card against the same run
                on the CPU (same init, same draws);
  5. main     — run_federated for ucfl, ucfl_k4 and fedavg on the paper's
                §IV-A.1 scenario (n=10000, m=20, LeNet-5, D=47,571), with
                launch counters showing every mix and the UCFL Δ went
                through the kernels.
The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.data import FederatedData, scenario_label_shift  # noqa: E402
from repro_torch.fl import (FLConfig, SYSTEMS, TorchDraws,  # noqa: E402
                            run_federated)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models import lenet  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
D_LENET = 47571                # LeNet-5 on 28x28x1 with 47 classes
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MAIN = dict(n=10000, m=20, rounds=20, local_steps=10, batch_size=64,
            eval_every=5, leaves=10)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


_FLUSH = None


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of ``fn()`` over ``iters`` runs, CUDA events.
    Before each run a 128 MiB write evicts the 50 MB L2 (the kernel reads
    from HBM) and a spin kernel holds the stream, so the whole of ``fn``'s
    launches is queued before the start event runs."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def check_close(name, got, want, rtol, atol) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool(torch.all(err <= lim)):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {float(err.max()):.3e}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def lenet_leaf_sizes() -> list:
    p = lenet.init_params(torch.Generator(device="cuda").manual_seed(0),
                          lenet.LeNetConfig(), device="cuda")
    sizes = [v.numel() for v in p.values()]
    assert sum(sizes) == D_LENET and len(sizes) == MAIN["leaves"], sizes
    return sizes


def rand_rows(gen, k, m):
    w = torch.rand((k, m), generator=gen, device="cuda")
    return w / w.sum(1, keepdim=True)


def check_mixing(gen) -> dict:
    shapes = [(1, 20, D_LENET), (4, 20, D_LENET), (20, 20, D_LENET),
              (100, 100, D_LENET), (4, 20, 1), (4, 20, 127), (20, 20, 129),
              (7, 13, 4099)]
    for k, m, d in shapes:
        for dt in (torch.float32, torch.bfloat16):
            w = rand_rows(gen, k, m)
            theta = torch.randn((m, d), generator=gen, device="cuda").to(dt)
            got = ops.mixing_aggregate(w, theta)
            want = ref.mixing_aggregate_ref(w, theta)
            err = check_close(f"mixing_aggregate k={k} m={m} D={d} {dt}",
                              got, want, TOL[dt], TOL[dt])
            line = f"  mixing_aggregate k={k:3d} m={m:3d} D={d:6d} " \
                   f"{str(dt)[6:]:8s} max|err| {err:.2e}"
            if d == D_LENET:
                n_bytes = (m * d + k * d) * theta.element_size() + 4 * k * m
                b, by = bound_ms(n_bytes, 2.0 * k * m * d)
                line += (f"  kernel {time_ms(lambda: ops.mixing_aggregate(w, theta)):.4f} ms"
                         f"  plain {time_ms(lambda: ref.mixing_aggregate_ref(w, theta)):.4f} ms"
                         f"  matmul {time_ms(lambda: torch.matmul(w.to(dt), theta)):.4f} ms"
                         f"  bound {b:.4f} ms ({by})")
            print(line, flush=True)
    theta = torch.randn((20, D_LENET), generator=gen, device="cuda")
    if not torch.equal(ops.mixing_aggregate(torch.eye(20, device="cuda"),
                                            theta), theta):
        raise AssertionError("mixing_aggregate: identity W does not "
                             "return Θ")

    # the main path's shapes: one ucfl round mixes the 10 LeNet leaves
    sizes = lenet_leaf_sizes()
    m = k = MAIN["m"]
    w = rand_rows(gen, k, m)
    thetas = [torch.randn((m, d), generator=gen, device="cuda")
              for d in sizes]
    err = max(check_close("mixing_aggregate (LeNet leaves)",
                          ops.mixing_aggregate(w, t),
                          ref.mixing_aggregate_ref(w, t), 1e-5, 1e-5)
              for t in thetas)
    n_bytes = sum((m * d + k * d) * 4 + 4 * k * m for d in sizes)
    b, by = bound_ms(n_bytes, 2.0 * k * m * D_LENET)
    row = dict(
        name="mixing_aggregate", route="cuda",
        source="src/repro_torch/kernels/csrc/mixing_aggregate.cu",
        replaces="src/repro/kernels/mixing_aggregate.py:43",
        max_abs_err=err,
        ms=time_ms(lambda: [ops.mixing_aggregate(w, t) for t in thetas]),
        plain_ms=time_ms(lambda: [ref.mixing_aggregate_ref(w, t)
                                  for t in thetas]),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: [torch.matmul(w, t) for t in thetas]))
    print(f"  mixing_aggregate main-path round (k=m=20, 10 leaves, "
          f"ΣD={D_LENET}, f32): kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  matmul {row['library_ms']:.4f} ms  "
          f"bound {b:.4f} ms ({by})  max|err| {err:.2e}", flush=True)
    return row


def check_gram(gen) -> dict:
    row = None
    for m, d in ((20, D_LENET), (100, D_LENET), (17, 31), (1, 5)):
        g = torch.randn((m, d), generator=gen, device="cuda")
        err = check_close(f"gram_matrix m={m} D={d}", ops.gram_matrix(g),
                          ref.gram_ref(g), 1e-4, 1e-2)
        # Δ's plain version assembles from the plain Gram, as the kernel
        # path does: pairwise_sqdist_ref's separately summed norms leave a
        # cancellation residue of ~1e-2 on its diagonal at this D
        delta = ops.pairwise_sqdist(g)
        check_close(f"pairwise_sqdist m={m} D={d}", delta,
                    ref.sqdist_from_gram(ref.gram_ref(g)), 1e-4, 1e-2)
        if not torch.equal(delta, delta.T) or \
                bool(torch.any(torch.diagonal(delta) != 0)):
            raise AssertionError(f"pairwise_sqdist m={m}: Δ not symmetric "
                                 "with a zero diagonal")
        line = f"  gram_matrix m={m:3d} D={d:6d} max|err| {err:.2e}"
        if d == D_LENET:
            b, by = bound_ms(4.0 * (m * d + m * m), 2.0 * m * m * d)
            cur = dict(
                name="gram_matrix", route="cuda",
                source="src/repro_torch/kernels/csrc/gram.cu",
                replaces="src/repro/kernels/pairwise_sqdist.py:42",
                max_abs_err=err,
                ms=time_ms(lambda: ops.gram_matrix(g)),
                plain_ms=time_ms(lambda: ref.gram_ref(g)),
                bound_ms=b, bound_by=by,
                library_ms=time_ms(lambda: torch.matmul(g, g.T)))
            line += (f"  kernel {cur['ms']:.4f} ms  plain "
                     f"{cur['plain_ms']:.4f} ms  matmul "
                     f"{cur['library_ms']:.4f} ms  bound {b:.4f} ms ({by})")
            if m == MAIN["m"]:
                row = cur
        print(line, flush=True)
    return row


# ---------------------------------------------------------------------------
# phases 4-5: the round engine


def small_agreement() -> None:
    """ucfl_k2 on a small scenario, on the card and on the CPU, from the
    same init and the same draws: histories agree, params within 1e-3."""
    fed_cpu = scenario_label_shift(3, n=600, m=6, device="cpu")
    fed_gpu = FederatedData(*(t.to("cuda") for t in fed_cpu))
    cfg = lenet.LeNetConfig()
    p0 = lenet.init_params(torch.Generator().manual_seed(5), cfg,
                           device="cpu")
    fl = FLConfig(rounds=3, local_steps=3, batch_size=16, eval_every=1)
    runs = {}
    for dev, fed in (("cpu", fed_cpu), ("cuda", fed_gpu)):
        runs[dev] = run_federated(
            "ucfl_k2", fed, fl=fl, system=SYSTEMS["wireless_slow"],
            model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
            draws=TorchDraws(11, "cpu"), keep_state=True, device=dev)
    a, b = runs["cpu"], runs["cuda"]
    flip = 1.0 / (fed_cpu.m * fed_cpu.x_val.shape[1])
    if a.comm != b.comm or a.time != b.time:
        raise AssertionError("cuda and cpu runs disagree on comm/time")
    if list(a.extras.assignment) != list(b.extras.assignment):
        raise AssertionError("cuda and cpu runs disagree on the stream plan")
    acc_err = max(abs(x - y) for x, y in zip(a.mean_acc + a.worst_acc,
                                             b.mean_acc + b.worst_acc))
    if acc_err > 2 * flip + 1e-6:
        raise AssertionError(f"accuracies differ by {acc_err}")
    perr = 0.0
    for k, v in a.final_params.items():
        got = b.final_params[k].cpu()
        perr = max(perr, float((got - v).abs().max()))
        if not torch.allclose(got, v, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"final param {k} differs cuda vs cpu")
    print(f"  ucfl_k2 n=600 m=6: cuda agrees with cpu (max |Δparam| "
          f"{perr:.2e}, max |Δacc| {acc_err:.4f})", flush=True)


def main_path() -> dict:
    t0 = time.perf_counter()
    fed = scenario_label_shift(0, n=MAIN["n"], m=MAIN["m"], device="cuda")
    torch.cuda.synchronize()
    print(f"  data: x {tuple(fed.x.shape)}  x_val {tuple(fed.x_val.shape)}  "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    fl = FLConfig(rounds=MAIN["rounds"], local_steps=MAIN["local_steps"],
                  batch_size=MAIN["batch_size"], eval_every=MAIN["eval_every"])
    system = SYSTEMS["wireless_slow"]
    m, rounds = MAIN["m"], MAIN["rounds"]
    ops.reset_launches()          # counts from here on are the main path's
    for spec in ("ucfl", "ucfl_k4", "fedavg"):
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        h = run_federated(spec, fed, fl=fl, system=system, seed=0,
                          device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        streams = h.comm[0].n_streams
        if not all(math.isfinite(a) for a in h.mean_acc + h.worst_acc):
            raise AssertionError(f"{spec}: non-finite accuracy {h.mean_acc}")
        if not h.mean_acc[-1] > 2.0 / 47:
            raise AssertionError(f"{spec}: final mean_acc {h.mean_acc[-1]} "
                                 "not above 2/47")
        ok = {"ucfl": streams == m, "ucfl_k4": 1 <= streams <= 4,
              "fedavg": streams == 1}[spec]
        if not ok:
            raise AssertionError(f"{spec}: {streams} streams")
        if [tuple(c) for c in h.comm] != [(streams, 0)] * rounds:
            raise AssertionError(f"{spec}: comm {h.comm}")
        t, want_time = 0.0, []
        for rnd in range(rounds):
            t += system.round_time(m, n_streams=streams, n_unicasts=0)
            if rnd % fl.eval_every == 0 or rnd == rounds - 1:
                want_time.append(t)
        if h.time != want_time:
            raise AssertionError(f"{spec}: clock {h.time} != {want_time}")
        if launched["mixing_aggregate"] != rounds * MAIN["leaves"]:
            raise AssertionError(f"{spec}: {launched} mixing launches, want "
                                 f"{rounds * MAIN['leaves']}")
        if launched["gram_matrix"] != (1 if spec.startswith("ucfl") else 0):
            raise AssertionError(f"{spec}: {launched} gram launches")
        print(f"  {spec:8s} streams {streams:2d}  mean_acc "
              f"{[round(a, 4) for a in h.mean_acc]}  worst_acc "
              f"{h.worst_acc[-1]:.4f}  time {h.time[-1]:.4f}  launches "
              f"{launched}  wall {wall:.2f} s ({wall / rounds * 1e3:.1f} "
              f"ms/round incl. setup)", flush=True)
    return dict(ops.LAUNCHES)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(f"[device] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}  "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    print("[build]", flush=True)
    t0 = time.perf_counter()
    for name, res in _build.build_all().items():
        print(f"  {name}.cu: {res.seconds:.2f} s -> {res.path.name}")
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"    {ln.strip()}")
    print(f"  build wall {time.perf_counter() - t0:.2f} s", flush=True)

    print("[kernels] kernel vs plain version on the card "
          f"(median CUDA-event ms, L2 flushed; {card})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_mixing(gen), check_gram(gen)]
    print("kernels: " + ", ".join(f"{r['name']} ok" for r in rows),
          flush=True)

    print("[agree] small run, cuda against cpu", flush=True)
    small_agreement()

    print(f"[main] run_federated n={MAIN['n']} m={MAIN['m']} LeNet-5 "
          f"D={D_LENET}", flush=True)
    launches = main_path()
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} never launched on the main "
                                 "path")
    print(f"  total wall {time.perf_counter() - t_start:.1f} s", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
