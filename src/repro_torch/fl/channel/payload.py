"""Bit-level payload accounting and the client-flat view of a stack.

Counterpart of `repro/fl/channel/payload.py`: exact bit counts of a
model dict from its leaves' dtypes (`ChannelCost` is the per-round
record the engine appends to `History.comm_bits`), and the loss-free
bridges between the client-stacked dict and the (m, D) f32 view the
codecs work on.

The flat view orders the leaves by sorted key, the order
`jax.tree_util.tree_leaves` gives a dict, so column j of the port's view
is column j of the reference's (LeNet: ``conv1_b, conv1_w, conv2_b, ...``
where the port's dict is built ``conv1_w, conv1_b, ...``).  Injected
codec noise is laid out in that order, so the order matters bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch


class ChannelCost(NamedTuple):
    """Per-round bit accounting: total downlink and uplink payload bits."""
    dl_bits: int
    ul_bits: int


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict / list / tuple in the reference's order
    (dict keys sorted); None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def dtype_bits(dtype) -> int:
    """Bits per element on the wire for a torch or numpy ``dtype`` (8 ·
    itemsize; bools ride as bytes)."""
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize) * 8
    return int(np.dtype(dtype).itemsize) * 8


def leaf_bits(leaf) -> int:
    return int(np.prod(tuple(leaf.shape)) or 1) * dtype_bits(
        getattr(leaf, "dtype", np.float32))


def tree_bits(tree: Any) -> int:
    """Exact payload bits of one model dict (e.g. a single client's)."""
    return sum(leaf_bits(l) for l in tree_leaves(tree))


def tree_size(tree: Any) -> int:
    """Total element count across all leaves (codec payload arithmetic)."""
    return sum(int(np.prod(tuple(l.shape)) or 1) for l in tree_leaves(tree))


def stacked_ravel(stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Client-stacked dict (every leaf (m, ...)) -> (m, D) f32 flat view,
    leaves in sorted-key order."""
    leaves = tree_leaves(stacked)
    m = leaves[0].shape[0]
    return torch.cat([l.reshape(m, -1).float() for l in leaves], dim=1)


def stacked_unravel(flat: torch.Tensor, like: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of `stacked_ravel`: split (m, D) back into ``like``'s keys,
    shapes and dtypes (columns in sorted-key order, the dict in ``like``'s
    own key order)."""
    names = sorted(like)
    sizes = [int(np.prod(tuple(like[k].shape[1:]))) or 1 for k in names]
    if sum(sizes) != flat.shape[1]:
        raise ValueError(f"flat view has {flat.shape[1]} columns, the stack "
                         f"{sum(sizes)}")
    out = {}
    for name, part in zip(names, torch.split(flat, sizes, dim=1)):
        out[name] = part.reshape(like[name].shape).to(like[name].dtype)
    return {name: out[name] for name in like}
