"""Collective schedules for user-centric aggregation over ranks.

Counterpart of `repro/core/distributed.py`.  The reference is one
controller with the client stack sharded over a mesh axis, and its
schedules are `shard_map` bodies.  Here every rank of a
`torch.distributed` group runs the same program and holds its own
``mm = m / P`` client rows [r·mm, (r+1)·mm) of every (m, ...) leaf, so a
schedule is the same body written with c10d collectives:

  gspmd              all-gather Θ, then the host mix (`core.aggregation`)
                     on the gathered stack, and keep this rank's rows
  shard_map_streams  contrib = W[:, my cols] (k, mm) · Θ_local (mm, F) in
                     f32, one all-reduce (SUM) of the (k, ΣD) buffer, then
                     this rank's rows of ``assignment``
  shard_map_unicast  all-gather Θ (m, ΣD), then W[my rows] (mm, m) ·
                     gathered

Each collective moves one flat buffer: the leaves are laid side by side
in a (rows, ΣD) matrix (sorted keys), and each product is one call of
`kernels.ops.mixing_aggregate_leaves` on it (one launch of the Y = W Θ
kernel on the card, its plain version on the CPU).  ``group`` None is
the default process group; ``ONE_PROCESS`` is this process alone (the
one-rank mesh of `launch.mesh.make_host_mesh`), where every collective
is the identity and none is issued, whatever group may be running.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.aggregation import (stream_aggregate,
                                          user_centric_aggregate)
from repro_torch.core.streams import StreamPlan
from repro_torch.kernels import ops

MIX_SCHEDULES = ("gspmd", "shard_map_streams", "shard_map_unicast")

# the installed PyTorch's name for the all-gather into one tensor (newer
# releases call it `all_gather_single` and deprecate the older name)
_ALL_GATHER = (dist.all_gather_single if hasattr(dist, "all_gather_single")
               else dist.all_gather_into_tensor)


# the group of this process alone
ONE_PROCESS = object()


def group_rank_size(group: Optional[Any]) -> Tuple[int, int]:
    """(this rank's index in ``group``, the group's size)."""
    if group is ONE_PROCESS:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather_rows(local: torch.Tensor, group: Optional[Any]
                    ) -> torch.Tensor:
    """(mm, ...) on every rank -> (P·mm, ...), the ranks' rows in order."""
    if group is ONE_PROCESS:
        return local
    _, size = group_rank_size(group)
    local = local.contiguous()
    out = torch.empty((size * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    _ALL_GATHER(out, local, group=group)
    return out


def _flat(stacked: Dict[str, torch.Tensor],
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The leaves side by side as one (rows, ΣD) matrix, sorted keys."""
    return torch.cat([stacked[k].reshape(stacked[k].shape[0], -1)
                      .to(dtype or stacked[k].dtype) for k in sorted(stacked)],
                     dim=1)


def _unflat(flat: torch.Tensor, like: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Inverse of `_flat` for ``flat``'s rows, each leaf in ``like``'s
    dtype."""
    out, at = {}, 0
    for k in sorted(like):
        shape = tuple(like[k].shape[1:])
        width = 1
        for s in shape:
            width *= s
        out[k] = flat[:, at:at + width].reshape(
            (flat.shape[0],) + shape).to(like[k].dtype)
        at += width
    return {k: out[k] for k in like}


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict / tuple (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for v in tree for t in _leaves(v)]


def gather_tree(tree: Any, group: Optional[Any]) -> Any:
    """All-gather every (mm, ...) leaf of a nested dict / tuple to (m,
    ...): one collective per leaf dtype, the leaves of a dtype laid side
    by side in one buffer (``None`` stays)."""
    ls = _leaves(tree)
    if not ls or group is ONE_PROCESS:
        return tree
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(ls):
        groups.setdefault(t.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(ls)
    for idx in groups.values():
        flat = torch.cat([ls[i].reshape(ls[i].shape[0], -1) for i in idx],
                         dim=1)
        full = all_gather_rows(flat, group)
        at = 0
        for i in idx:
            width = ls[i][0].numel()
            out[i] = full[:, at:at + width].reshape(
                (full.shape[0],) + tuple(ls[i].shape[1:]))
            at += width
    it = iter(out)
    return _rebuild(tree, it)


def _rebuild(tree: Any, it) -> Any:
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        kids = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: kids[k] for k in tree}
    kids = [_rebuild(v, it) for v in tree]
    return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)


def mix_streams(group: Optional[Any], params: Dict[str, torch.Tensor],
                centroids: torch.Tensor,
                assignment: torch.Tensor) -> Dict[str, torch.Tensor]:
    """θ_i ← θ̂_{a(i)}, θ̂ = Ŵ Θ by one all-reduce of the k weighted
    copies: centroids (k, m), assignment (m,) int."""
    r, size = group_rank_size(group)
    mm = centroids.shape[1] // size
    w_cols = centroids[:, r * mm:(r + 1) * mm].to(torch.float32)
    contrib = ops.mixing_aggregate_leaves(
        w_cols, [_flat(params, torch.float32)])[0]           # (k, ΣD)
    contrib = contrib.contiguous()
    if group is not ONE_PROCESS:
        dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
    mine = assignment[r * mm:(r + 1) * mm].to(torch.int64)
    return _unflat(contrib.index_select(0, mine), params)


def mix_unicast(group: Optional[Any], params: Dict[str, torch.Tensor],
                w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """θ_i ← Σ_j W[i,j] θ_j by one all-gather of Θ and a local mix with
    this rank's rows of W (m, m)."""
    r, size = group_rank_size(group)
    mm = w.shape[0] // size
    gathered = all_gather_rows(_flat(params, torch.float32), group)
    w_rows = w[r * mm:(r + 1) * mm].to(torch.float32)
    return _unflat(ops.mixing_aggregate_leaves(w_rows, [gathered])[0],
                   params)


def mix_gspmd(group: Optional[Any], params: Dict[str, torch.Tensor],
              w: torch.Tensor, assignment: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
    """All-gather Θ, the host mix (`user_centric_aggregate`, or
    `stream_aggregate` of the plan) on the gathered stack, this rank's
    rows of the result."""
    r, size = group_rank_size(group)
    gathered = gather_tree(params, group)
    if assignment is None:
        mixed = user_centric_aggregate(gathered, w)
    else:
        mixed = stream_aggregate(gathered, StreamPlan(w, assignment, None))
    mm = next(iter(gathered.values())).shape[0] // size
    return {k: v[r * mm:(r + 1) * mm] for k, v in mixed.items()}


def mix_schedule(group: Optional[Any], params: Dict[str, torch.Tensor],
                 w: torch.Tensor, assignment: Optional[torch.Tensor] = None,
                 *, schedule: str = "gspmd") -> Dict[str, torch.Tensor]:
    """One entry point for every schedule, the reference's dispatch.

    ``params`` holds this rank's (mm, ...) rows.  ``assignment=None``
    means ``w`` is a full per-client matrix (m, m); otherwise ``w`` is
    the (k, m) centroid rules and ``assignment`` the (m,) client→stream
    map.  Returns this rank's (mm, ...) rows of the mixed stack."""
    if schedule == "gspmd":
        return mix_gspmd(group, params, w, assignment)
    if schedule == "shard_map_streams":
        if assignment is None:          # full matrix: one stream per client
            assignment = torch.arange(w.shape[0], device=w.device)
        return mix_streams(group, params, w, assignment)
    if schedule == "shard_map_unicast":
        full_w = w if assignment is None else w[assignment.to(torch.int64)]
        return mix_unicast(group, params, full_w)
    raise ValueError(f"unknown mixing schedule {schedule!r}; "
                     f"one of {sorted(MIX_SCHEDULES)}")
