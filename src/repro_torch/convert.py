"""Carry weights and data across from the reference package as numpy.

The reference hands its ``params0``, stacked params, optimizer state and
scenario arrays over as numpy (``np.asarray`` of its arrays); these
helpers turn them into the port's tensors and back.  Nothing here
imports JAX: the caller does the ``np.asarray``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device


def tree_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Nested dict (or None) of numpy arrays -> same structure of tensors."""
    dev = resolve_device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev)


def tree_to_numpy(tree: Any) -> Any:
    """Nested dict (or None) of tensors -> same structure of numpy arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def fed_from_numpy(x, y, n, x_val, y_val, group,
                   device: DeviceLike = "cuda") -> FederatedData:
    """The port's `FederatedData` from the reference's scenario arrays."""
    dev = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=dev)
    return FederatedData(f32(x), i64(y), f32(n), f32(x_val), i64(y_val),
                         i64(group))
