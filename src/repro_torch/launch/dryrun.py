"""The planner: each (arch × input shape) case counted on ``meta`` tensors,
its roofline on one H100 and its memory verdict.

Counterpart of `repro/launch/dryrun.py`.  The reference lowers and
compiles every case on a forced 512-device host mesh and reads XLA's
cost and memory analyses.  The port has no compiler to ask: it runs the
case's step function (`launch/steps.py`'s `build_case`) on ``meta``
tensors, which carry shapes and dtypes and no data, and counts what runs:

- FLOPs a device: `torch.utils.flop_counter.FlopCounterMode` (the flash
  op's formula counts only the (query, key) pairs its mask keeps,
  `kernels/ops.py`);
- bytes a device: `_Traffic`, a `TorchDispatchMode` that sums each op's
  operand and result bytes (views move none).  This is eager op traffic,
  every intermediate read and written once, not XLA's fused "bytes
  accessed";
- collectives: the c10d ops the case issues, recorded by `_Traffic` as
  (kind, output bytes) and summed by `roofline.collective_bytes`.  One
  process alone issues none (`core/distributed.py`);
- peak memory a device: the arguments' bytes (params, optimizer state,
  batch, caches) plus the peak of the bytes the run allocates and still
  holds, tracked storage by storage (`_Traffic`), with no allocation.

As the reference does (XLA counts a scan body once), the counts come from
the loop form at 2 and 3 pattern blocks, extrapolated to the real depth
(`extrapolated_costs`): every count is affine in the number of groups.
The temporaries' peak comes from the case as built (scanned, with its
``remat``) at 2 and 3 groups, extrapolated the same way.  The
``microbatch`` slices run one after another in Python, so each slice's
work is counted as it runs (the reference scales XLA's once-counted
accumulation loop by ``microbatch`` instead).

The mesh is `make_card_mesh()`: one rank a card (one process: one card).
A module that reads a tensor back to the host cannot run on ``meta``:
such a case fails here and names the op; it never records a zero.

    python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--out DIR] [--shard I/N]
        [--skip-existing]

``--shard I/N`` plans every N-th case of the list from the I-th, so N
processes side by side plan ``--all`` between them.  ``--skip-existing``
reports a case whose artifact is already under ``--out`` as skipped and
does not plan it, as the reference's does.

Artifacts: ``<out>/<mesh>/<arch>__<shape>[__tag].json`` (default ``out``
``build/dryrun_artifacts`` at the repo root), each with the
`RooflineTerms` fields, the counts before extrapolation, ``fits`` (the
estimated peak at most the card's memory, the datasheet's 80 GB beside
it) and what was counted how.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import HBM_BYTES, Mesh, make_card_mesh
from repro_torch.launch.steps import INPUT_SHAPES, build_case
from repro_torch.models.scan import layer_grouping
from repro_torch.roofline.analysis import (collective_bytes, model_flops,
                                           roofline)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun_artifacts")

# c10d op -> the reference's collective kind
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    """Bytes of the distinct storages a tree's tensors hold."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


class _Traffic(TorchDispatchMode):
    """Counts, op by op: operand + result bytes of every op that is not a
    view; the bytes of the storages the run allocated and still holds
    (``live``, its peak ``peak``); and the collectives (``collectives``,
    (kind, output bytes)).  A host read of a ``meta`` tensor raises,
    naming the op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.collectives: List[Tuple[str, float]] = []
        self._held = set()

    def _free(self, key, n):
        self._held.discard(key)
        self.live -= n

    def _hold(self, out, inputs):
        """Hold the storages ``out`` has that none of the op's inputs
        had: a view, an in-place result or an argument's storage is none
        of the run's allocations."""
        seen = {id(t.untyped_storage()) for t in inputs}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._held or key in seen:
                continue
            n = st.nbytes()
            self._held.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(func._schema.name.split("::")[-1])
            if kind is None:
                raise NotImplementedError(f"planner: collective {func}")
            ins = _tensors((args, kwargs))
            if any(t.device.type == "meta" for t in ins):
                raise NotImplementedError(
                    f"planner: {func} on meta tensors; the planner plans "
                    "one process, which issues no collective")
            out = func(*args, **kwargs)
            self.collectives.append(
                (kind, sum(_nbytes(t) for t in _tensors(out))))
            return out
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            raise RuntimeError(f"planner: {func} cannot run on meta tensors "
                               f"({e})") from e
        ins = _tensors((args, kwargs))
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self._hold(out, ins)
        return out


def count_case(case) -> Dict[str, Any]:
    """One run of ``case.fn`` on its ``meta`` arguments: FLOPs, bytes,
    collectives and the temporaries' peak."""
    traffic = _Traffic()
    flops = FlopCounterMode(display=False)
    with flops, traffic:
        out = case.fn(*case.args)
    del out
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(traffic.bytes),
            "collectives": {k: float(v) for k, v in
                            collective_bytes(traffic.collectives).items()},
            "temp_peak": float(traffic.peak)}


def _at_groups(cfg, g: int):
    n_pre, period, _ = layer_grouping(cfg)
    return dataclasses.replace(cfg, n_layers=n_pre + g * period)


def _lin(v2: float, v3: float, groups: int) -> float:
    return v2 + (groups - 2) * (v3 - v2)


def extrapolated_costs(cfg, mesh: Mesh, shape_name: str, kw: dict
                       ) -> Optional[Dict[str, Any]]:
    """The loop form's counts at 2 and 3 pattern blocks, extrapolated to
    the config's groups (None where the config has at most 3 groups, or
    no scan: count the case itself)."""
    if cfg.family == "audio":
        return None
    _, _, groups = layer_grouping(cfg)
    if groups <= 3:
        return None
    vals = {g: count_case(build_case(_at_groups(cfg, g), mesh, shape_name,
                                     **dict(kw, loop=True)))
            for g in (2, 3)}
    return {"flops": _lin(vals[2]["flops"], vals[3]["flops"], groups),
            "bytes": _lin(vals[2]["bytes"], vals[3]["bytes"], groups),
            "collectives": {k: _lin(vals[2]["collectives"][k],
                                    vals[3]["collectives"][k], groups)
                            for k in vals[2]["collectives"]}}


def temp_peak(cfg, mesh: Mesh, shape_name: str, kw: dict) -> float:
    """The temporaries' peak of the case as built (scanned, with its
    ``remat``) at 2 and 3 groups, extrapolated to the config's."""
    _, _, groups = layer_grouping(cfg)
    t = {g: count_case(build_case(_at_groups(cfg, g), mesh, shape_name,
                                  **kw))["temp_peak"] for g in (2, 3)}
    return _lin(t[2], t[3], groups)


def apply_overrides(cfg, overrides: dict):
    """dataclasses.replace with dotted paths, e.g. {"attn.mla_absorb": True}."""
    for path, value in (overrides or {}).items():
        parts = path.split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: value})
        else:
            sub = getattr(cfg, parts[0])
            sub = apply_overrides(sub, {".".join(parts[1:]): value})
            cfg = dataclasses.replace(cfg, **{parts[0]: sub})
    return cfg


def mesh_name(mesh: Mesh) -> str:
    return "card" + "x".join(str(s) for s in mesh.sizes)


def card_bytes(mesh: Mesh) -> Optional[float]:
    """The card's memory, where the mesh's device is a card."""
    if mesh.device.type != "cuda":
        return None
    return float(torch.cuda.get_device_properties(mesh.device).total_memory)


def run_case(arch: str, shape_name, *, mesh: Optional[Mesh] = None,
             schedule: str = "gspmd", n_streams: int = 4, remat: bool = True,
             microbatch: int = 1, tag: str = "", verbose: bool = True,
             out_dir: Optional[str] = ARTIFACT_DIR, overrides: dict = None,
             cfg=None) -> dict:
    """Plan one case and write its artifact (``out_dir`` None: write
    nothing).  ``shape_name`` an `INPUT_SHAPES` name or an `InputShape`;
    ``cfg`` replaces ``arch``'s config (a cut depth, a smoke config);
    ``overrides`` as `apply_overrides`."""
    cfg = apply_overrides(cfg if cfg is not None else get_config(arch),
                          overrides)
    mesh = mesh if mesh is not None else make_card_mesh()
    name = mesh_name(mesh)
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    kw = {}
    if shape.kind == "train":
        kw = dict(schedule=schedule, n_streams=n_streams, remat=remat,
                  microbatch=microbatch)
    t0 = time.time()
    case = build_case(cfg, mesh, shape_name, **kw)
    args_bytes = float(tree_bytes(case.args))
    extra = extrapolated_costs(cfg, mesh, shape_name, kw)
    if extra is None:
        costs = count_case(case)
        temps = costs["temp_peak"]
    else:
        costs, temps = extra, temp_peak(cfg, mesh, shape_name, kw)
    flops_dev, bytes_dev = costs["flops"], costs["bytes"]
    coll = costs["collectives"]
    t_plan = time.time() - t0
    peak = args_bytes + temps
    total = card_bytes(mesh)
    mf = model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
    terms = roofline(arch, shape.name, name, mesh.size, flops_dev, bytes_dev,
                     float(sum(coll.values())), mf, peak)
    result = terms.as_dict()
    result.update({
        "collectives": coll,
        "extrapolated": extra is not None,
        "microbatch": microbatch,
        "remat": remat if shape.kind == "train" else None,
        "argument_bytes": args_bytes,
        "temp_peak_bytes": temps,
        "card_memory_bytes": total,
        "datasheet_memory_bytes": HBM_BYTES,
        "fits": peak <= (total if total is not None else HBM_BYTES),
        "plan_seconds": t_plan,
        "meta": case.meta,
        "counted_on": "meta tensors (shapes only, no device run)",
        "bytes_are": "eager op traffic: each op's operands and results, "
                     "views none; not a fused program's bytes accessed",
    })
    if verbose:
        print(f"== {arch} x {shape.name} x {name} (planned on meta, "
              f"{t_plan:.1f} s) ==")
        print(f"  flops/device {flops_dev:.4g}  bytes/device "
              f"{bytes_dev:.4g}  extrapolated {extra is not None}")
        print(f"  roofline: compute {terms.t_compute * 1e3:.3f} ms  memory "
              f"{terms.t_memory * 1e3:.3f} ms  collective "
              f"{terms.t_collective * 1e3:.3f} ms -> {terms.bottleneck}; "
              f"useful-flops ratio {terms.useful_flops_ratio:.3f}")
        print(f"  peak {peak / 2**30:.2f} GiB (args {args_bytes / 2**30:.2f}"
              f" + temporaries {temps / 2**30:.2f}); fits "
              f"{result['fits']}")
    if out_dir is not None:
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(out_dir, name,
                            f"{arch}__{shape.name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    p.add_argument("--all", action="store_true",
                   help="every (arch x shape) on the card mesh")
    p.add_argument("--schedule", default="gspmd",
                   choices=("gspmd", "shard_map_streams", "shard_map_unicast"))
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--microbatch", type=int, default=1)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--tag", default="")
    p.add_argument("--skip-existing", action="store_true",
                   help="report a case whose artifact is under --out as "
                        "skipped and do not plan it")
    p.add_argument("--out", default=ARTIFACT_DIR)
    p.add_argument("--shard", default="0/1",
                   help="I/N: plan only every N-th case, from the I-th")
    p.add_argument("--device", default=None,
                   help="the mesh's device (default: card 0; 'meta' plans "
                        "with no card)")
    args = p.parse_args(argv)
    if args.all:
        # shape-major: a shard's cases spread over the architectures
        combos = [(a, s) for s in INPUT_SHAPES for a in ARCH_IDS]
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    i, n = (int(x) for x in args.shard.split("/"))
    combos = combos[i::n]
    mesh = make_card_mesh(args.device)
    failures = []
    suffix = f"__{args.tag}" if args.tag else ""
    for a, s in combos:
        path = os.path.join(args.out, mesh_name(mesh),
                            f"{a}__{s}{suffix}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"skip {a} x {s} (artifact exists)")
            continue
        try:
            run_case(a, s, mesh=mesh, schedule=args.schedule,
                     n_streams=args.streams, remat=not args.no_remat,
                     microbatch=args.microbatch, tag=args.tag,
                     out_dir=args.out)
        except Exception as e:  # noqa: BLE001 - report and go on
            traceback.print_exc()
            failures.append((a, s, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("dry-run OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
