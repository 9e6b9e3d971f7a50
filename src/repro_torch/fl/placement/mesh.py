"""Mesh placement: clients sharded over the ranks of a process group.

Counterpart of `repro/fl/placement/mesh.py`.  The reference is one
controller whose client stack is sharded ``P("clients")`` over a device
mesh, with GSPMD or `shard_map` inserting the collectives.  Here every
rank of a `torch.distributed` group runs the same `run_federated` call
and holds only its ``mm = m / P`` client rows [r·mm, (r+1)·mm) of the
stack, the optimizer state, the data and the residuals, as plain local
tensors; the mix is one of the `core.distributed` schedules, c10d
collectives around the Y = W Θ kernel:

  gspmd               all-gather Θ, the host mix, this rank's rows
  shard_map_streams   one all-reduce of the k weighted copies
  shard_map_unicast   one all-gather of Θ, then this rank's rows of W

The draws stay those of `HostVmap`: every rank draws every draw in full
(m rows) from the same generator and keeps its rows (`rows`), so a run's
draw streams are the single-device run's.  What reads the whole stack
(the eval scores, ``keep_state``'s final params, fedfomo's candidates,
cfl's statistics, the robust defenses, a paged chunk's rows before
`Placement.fetch` copies them to the host) goes through `gather`,
replicated on every rank.

``group=None`` with no process group running starts a one-rank group in
this process (`dist.HashStore`, no network): NCCL on ``cuda``, gloo on
``cpu``.  A running group is used as it is, and its backend must fit the
device (``ValueError`` otherwise; nothing switches backend).  With no
explicit group the client axis is the reference's auto rule: the
largest divisor d of m that is ≤ the world size, rebound when m
changes (the groups of every size are built once, when the placement
first sees the world); ranks ≥ d hold no clients and receive rank 0's
`History` (`share`), or, at a paged async event, the event's rows.

The channel codecs run their ``"jnp"`` backend here (`codec_backend`),
as the reference's do: QSGD bitwise the kernels' path, top-k with the
exact k-th magnitude.  On the card the fused chunk's collectives are
captured in its CUDA graph with the rest of the round.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.distributed import (MIX_SCHEDULES, gather_tree,
                                          mix_schedule)
from repro_torch.core.streams import StreamPlan
from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.placement.base import (Placement, client_scores,
                                           stack_params)
from repro_torch.fl.placement.copies import Staged, stage_tree
from repro_torch.fl.placement.graphs import tree_map
from repro_torch.fl.placement.host import cached_update, reduce_scores

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# the auto rule's groups of each running world: {world group: {d: the
# group of ranks 0..d-1 (None for the world itself)}}
_AUTO_GROUPS: Dict[Any, Dict[int, Any]] = {}


def _auto_groups() -> Dict[int, Any]:
    """The groups of ranks 0..d-1 for every d up to the world size, built
    once per world by every rank in the same order, the first time a
    placement sees it.  `dist.new_group` is a call of every rank of the
    world, so building them all up front lets a rank that holds no
    clients at one event (a paged async cohort) skip that event's work
    instead of joining a group's construction."""
    world_group = dist.group.WORLD
    groups = _AUTO_GROUPS.get(world_group)
    if groups is None:
        world = dist.get_world_size()
        groups = {d: (None if d == world else
                      dist.new_group(ranks=list(range(d))))
                  for d in range(1, world + 1)}
        _AUTO_GROUPS[world_group] = groups
    return groups


class MeshShardMap(Placement):
    """Clients sharded over the ranks of ``group``; collective mixing."""

    name = "mesh_shard_map"
    codec_backend = "jnp"

    def __init__(self, group: Optional[Any] = None, *,
                 schedule: str = "gspmd", device: DeviceLike = "cuda"):
        if schedule not in MIX_SCHEDULES:
            raise ValueError(f"unknown mixing schedule {schedule!r}; "
                             f"one of {sorted(MIX_SCHEDULES)}")
        self.schedule = schedule
        self.device = resolve_device(device)
        backend = _BACKENDS[self.device.type]
        if group is None and not dist.is_initialized():
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        got = dist.get_backend(group)
        if got != backend:
            raise ValueError(
                f"process group backend {got!r} does not fit "
                f"device={str(self.device)!r} (needs {backend!r})")
        self._auto = group is None
        self.group = group
        self._m: Optional[int] = None
        self._rank = self._size = self._ranks = None

    # ---- the client axis --------------------------------------------------

    def _ensure(self, m: int) -> None:
        """Bind the client axis to ``m`` clients: the auto group (built
        once per size, by every rank of the world in the same order) and
        this rank's place in it."""
        if m == self._m:
            return
        if self._auto:
            world = dist.get_world_size()
            d = max(k for k in range(1, min(world, m) + 1) if m % k == 0)
            self.group, ranks = _auto_groups()[d], list(range(d))
        else:
            ranks = dist.get_process_group_ranks(self.group)
        size = len(ranks)
        if m % size:
            raise ValueError(
                f"m={m} clients not divisible by the process group "
                f"(size {size}) — shard_map schedules need equal shards")
        me = dist.get_rank()
        self._m, self._size, self._ranks = m, size, tuple(ranks)
        self._rank = ranks.index(me) if me in ranks else None

    @property
    def rank(self) -> Optional[int]:
        """This rank's index on the client axis (None: it holds none)."""
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    def holds_clients(self, m: int) -> bool:
        self._ensure(m)
        return self._rank is not None

    def spans(self, m: int) -> bool:
        world = dist.get_world_size()
        if not self._auto and dist.get_world_size(self.group) != world:
            return False
        # the auto group for m is the world iff the world size divides m
        return m % world == 0

    def share(self, value: Any) -> Any:
        # every rank on the client axis computed the same value; the
        # others take rank 0's
        if self._size == dist.get_world_size():
            return value
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def rows(self, tree: Any) -> Any:
        m, r, size = self._m, self._rank, self._size
        mm = m // size

        def take(a):
            c = a.shape[0] // m
            if c * m != a.shape[0]:
                raise ValueError(f"leading dim {a.shape[0]} is not a "
                                 f"multiple of m={m}")
            return a[r * mm * c:(r + 1) * mm * c]

        return tree_map(take, tree)

    def gather(self, tree: Any) -> Any:
        return gather_tree(tree, self.group)

    # ---- Placement hooks --------------------------------------------------

    def build_update(self, loss_fn: Callable, fl) -> Tuple[Any, Callable]:
        # HostVmap's cached step: it runs on whatever rows it is given
        return cached_update(loss_fn, fl.local_steps, fl.batch_size, fl.lr,
                             fl.momentum,
                             getattr(fl, "opt_state_dtype", None))

    def stack(self, params0, m: int):
        self._ensure(m)
        return stack_params(params0, m // self._size)

    def place_data(self, fed: FederatedData) -> Tuple[Any, Any, Any]:
        self._ensure(fed.m)
        return self.rows((fed.x, fed.y, fed.n))

    def place_stack(self, tree: Any, m: int) -> Any:
        self._ensure(m)
        return self.rows(tree)

    def place_fleet(self, tree: Any, m: int, device: torch.device) -> Any:
        # users on dim 0 are sharded; the device axis rides inside a shard
        self._ensure(m)
        return self.rows(super().place_fleet(tree, m, device))

    def stage(self, tree: Any, m: int, device: torch.device) -> Staged:
        self._ensure(m)
        return stage_tree(self.rows(tree), device)

    def mix(self, stacked, w: torch.Tensor):
        return mix_schedule(self.group, stacked, w, schedule=self.schedule)

    def mix_plan(self, stacked, plan: StreamPlan):
        return mix_schedule(self.group, stacked, plan.centroids,
                            plan.assignment, schedule=self.schedule)

    def eval_traced(self, acc_fn: Callable, stacked: Any, x_val: Any,
                    y_val: Any) -> torch.Tensor:
        x_val, y_val = self.rows((x_val, y_val))
        return self.gather(client_scores(acc_fn, stacked, x_val, y_val))

    def evaluate(self, acc_fn: Callable, stacked, fed: FederatedData
                 ) -> Tuple[float, float]:
        return reduce_scores(self.eval_traced(acc_fn, stacked, fed.x_val,
                                              fed.y_val))

    def cache_key(self) -> Tuple:
        return (type(self).__name__, self._ranks, self.schedule,
                str(self.device))

    def __repr__(self) -> str:
        return (f"MeshShardMap(size={self._size}, "
                f"schedule={self.schedule!r}, device={str(self.device)!r})")
