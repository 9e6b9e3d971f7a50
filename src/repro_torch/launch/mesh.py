"""Meshes the port plans and runs on, and the FL client axes over them.

Counterpart of `repro/launch/mesh.py`.  The reference plans 256- and
512-chip TPU meshes with TPU constants.  The port runs one rank a card,
each rank holding its clients' full parameters (`fl/placement/mesh.py`,
`core/distributed.py`): there is no tensor parallelism, so its own mesh
is ``("data", "model")`` with ``"model"`` of size 1.  `Mesh` is a small
value type that plays the part of `jax.sharding.Mesh` for the sharding
rules (`launch/sharding.py`) and the case builders (`launch/steps.py`):
the axis names, the ordered name -> size map ``shape``, the rank's
device and its `torch.distributed` group (None for one process).

- `make_host_mesh`: the (1, 1) mesh of one process, on ``device``.
- `make_production_mesh`: the reference's (16, 16) and (2, 16, 16)
  shapes and axis names; it raises, as the reference does, when the
  cards present cannot fill the shape, and never gives a smaller mesh.
  The planner uses such shapes only to reckon what a GSPMD deployment
  would hold (the sharding rules); the port cannot run them.
- `make_card_mesh`: the planner's mesh: one rank a card present on
  ``"data"``, ``"model"`` of size 1.

Constants: the H100 SXM5's, for the planner's roofline and memory
verdicts (`roofline/analysis.py`, `launch/dryrun.py`) and
`chip_smoke.py`'s kernel bounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 part
# (https://www.nvidia.com/en-us/data-center/h100/): dense rates, without
# sparsity (the sheet's bf16 1,979 TFLOP/s is with it); NVLink's 900 GB/s
# is one GPU's total over both directions
PEAK_FLOPS_BF16 = 989e12        # tensor cores, dense
PEAK_FLOPS_F32 = 67e12          # outside the tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 900e9               # bytes/s, both directions together
HBM_BYTES = 80e9                # 80 GB


@dataclass(frozen=True)
class Mesh:
    """Axis names, ``shape`` (name -> size, in axis order), this rank's
    device and its process group (None for one process)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device = torch.device("cpu")
    group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_host_mesh(device="cuda") -> Mesh:
    """The (1, 1) ``("data", "model")`` mesh of one process."""
    from repro_torch.device import resolve_device
    return Mesh(("data", "model"), (1, 1), resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's (16, 16) ``("data", "model")`` or (2, 16, 16)
    ``("pod", "data", "model")`` mesh, one card a device: raises when the
    cards present cannot fill it."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in sizes:
        n *= s
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"mesh {sizes} needs {n} devices, found {have}; the port plans "
            "on make_card_mesh() (launch/dryrun.py)")
    return Mesh(axes, sizes, torch.device("cuda", 0))


def make_card_mesh(device=None) -> Mesh:
    """The planner's mesh: one rank a card on ``"data"``, ``"model"`` of
    size 1.  With a process group running, its world (this rank on card
    ``rank``); otherwise this process alone, on card 0 (or on
    ``device``: ``"meta"`` plans with no card)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        dev = torch.device(device) if device is not None else \
            torch.device("cuda", rank)
        return Mesh(("data", "model"), (world, 1), dev, dist.group.WORLD)
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_card_mesh(): no card; pass device='meta' "
                           "to plan without one")
    return Mesh(("data", "model"), (1, 1), dev)


def data_axes(mesh: Mesh) -> tuple:
    """The batch-sharding axes of a mesh (pod folds into data parallelism)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def client_axes(mesh: Mesh, cfg) -> tuple:
    """Mesh axes carrying the FL client dimension.

    "all" = client-per-device placement: weights replicated, every mesh
    axis carries clients, and the mixing collective is the whole of the
    communication.  "pod" = the clients span the pods.  Otherwise the data
    axes."""
    if cfg.fl_client_axis == "pod":
        return ("pod",) if "pod" in mesh.axis_names else ()
    if cfg.fl_client_axis == "all":
        return tuple(mesh.axis_names)
    return data_axes(mesh)


def n_clients(mesh: Mesh, cfg) -> int:
    n = 1
    for a in client_axes(mesh, cfg):
        n *= mesh.shape[a]
    return n
