"""Roofline: three terms a (arch × shape × mesh) case, from the planner's
counts.

Counterpart of `repro/roofline/analysis.py`, on one H100's rates
(`launch/mesh.py`, NVIDIA's datasheet):

    compute    = FLOPs a device      / PEAK_FLOPS_BF16
    memory     = bytes a device      / HBM_BW
    collective = collective bytes    / NVLINK_BW

The reference reads the FLOPs and bytes of XLA's partitioned program and
parses its collectives out of the optimized HLO.  The port has no HLO:
the planner (`launch/dryrun.py`) counts the ops a case runs on ``meta``
tensors, one rank's program, and records each collective that the case
issues as (kind, output bytes).  `collective_bytes` sums those records
into the reference's five kinds as `parse_collective_bytes` sums its HLO
lines: output bytes, an ``-start`` / ``-done`` pair counted once.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.configs.base import ModelConfig, active_param_count
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, float]]) -> Dict[str, int]:
    """Output bytes a collective kind, over (kind, output bytes) records:
    ``kind`` one of `COLLECTIVES`, or one with ``-start`` (counted) or
    ``-done`` (carries no new transfer: skipped)."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in records:
        if kind.endswith("-done"):
            continue
        base = kind[:-len("-start")] if kind.endswith("-start") else kind
        if base not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[base] += int(nbytes)
    return out


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_global: float
    useful_flops_ratio: float
    peak_memory_per_device: Optional[float] = None

    def as_dict(self):
        return asdict(self)


def model_flops(cfg: ModelConfig, shape_kind: str, seq_len: int,
                global_batch: int) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train), 2·N_active·tokens (serve)."""
    n = active_param_count(cfg)
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n * tokens
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n * tokens
    return 2.0 * n * global_batch          # decode: one token per sequence


def roofline(arch: str, shape: str, mesh_name: str, chips: int,
             flops_dev: float, bytes_dev: float, coll_dev: float,
             mflops: float, peak_mem: Optional[float] = None) -> RooflineTerms:
    t_c = flops_dev / PEAK_FLOPS_BF16
    t_m = bytes_dev / HBM_BW
    t_x = coll_dev / NVLINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops_dev * chips
    ratio = mflops / total_flops if total_flops else 0.0
    return RooflineTerms(arch, shape, mesh_name, chips, flops_dev, bytes_dev,
                         coll_dev, t_c, t_m, t_x, bottleneck, mflops, ratio,
                         peak_mem)
