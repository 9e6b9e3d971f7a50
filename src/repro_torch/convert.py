"""Carry weights and data across from the reference package as numpy.

The reference hands its ``params0``, stacked params, optimizer state,
scenario arrays and LM params (either layout for serving; the scanned
one, with its optimizer state, as the training engine's flat-key view,
MoE layers' leaves among them)
over as numpy (``np.asarray`` of its arrays; a bf16 leaf arrives as
``ml_dtypes.bfloat16``); these helpers turn them into the port's tensors
and back.  Nothing here imports JAX: the
caller does the ``np.asarray``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.scan import flat_params, layer_grouping, nest_params


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts, lists and tuples (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_tensor(a: Any, dev: torch.device) -> torch.Tensor:
    """One numpy array (or scalar) as a tensor on ``dev``; a bf16 array
    (``ml_dtypes.bfloat16``, which torch does not take) goes over by its
    bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=dev).view(torch.bfloat16)
    return torch.tensor(a, device=dev)


def tree_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """Nested dicts, lists and tuples (or None) of numpy arrays -> the same
    structure of tensors."""
    dev = resolve_device(device)
    return _tree_map(lambda a: _to_tensor(a, dev), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array; a bf16 one by its bits, as
    ``ml_dtypes.bfloat16`` (imported only then: the reference's side of
    the carry)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_to_numpy(tree: Any) -> Any:
    """Nested dicts, lists and tuples (or None) of tensors -> the same
    structure of numpy arrays."""
    return _tree_map(_to_numpy, tree)


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The reference's LM params (numpy) as the port's: either layout of
    the reference, ``T.init_params``'s ``layers`` list or
    ``init_model_params``'s scanned ``prefix_layers`` + ``scan_layers``
    (a tuple of ``period`` trees, each leaf stacked over the groups),
    becomes one ``layers`` list in layer order."""
    if "layers" in tree:
        layers = list(tree["layers"])
    elif "scan_layers" in tree:
        _, period, groups = layer_grouping(cfg)
        slots = tree["scan_layers"]
        if len(slots) != period:
            raise ValueError(f"{len(slots)} scan slots, config has period "
                             f"{period}")
        layers = list(tree.get("prefix_layers", []))
        for g in range(groups):
            for j in range(period):
                layers.append(_tree_map(lambda a, g=g: np.asarray(a)[g],
                                        slots[j]))
    else:
        raise ValueError("params hold neither 'layers' nor 'scan_layers'")
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers, config has {cfg.n_layers}")
    out = {k: v for k, v in tree.items()
           if k not in ("layers", "prefix_layers", "scan_layers")}
    out["layers"] = layers
    return tree_from_numpy(out, device)


def lm_view_from_numpy(tree: Dict[str, Any], device: DeviceLike = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """The reference's ``init_model_params`` tree (numpy; the scanned
    layout, client-stacked or not) as the port's flat-key view, the
    params dict the round engine carries (`models.scan.flat_params`)."""
    return tree_from_numpy(flat_params(tree), device)


def lm_view_to_numpy(flat: Dict[str, torch.Tensor],
                     cfg: ModelConfig) -> Dict[str, Any]:
    """Inverse of `lm_view_from_numpy`: the reference's scanned tree."""
    return nest_params(tree_to_numpy(flat))


def lm_opt_state_from_numpy(state: Dict[str, Any],
                            device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The reference's SGD state ``{"mu": tree or None, "step"}`` over the
    scanned layout as the port's, ``mu`` in the flat-key view."""
    mu = state["mu"]
    return {"mu": None if mu is None else lm_view_from_numpy(mu, device),
            "step": tree_from_numpy(state["step"], device)}


def lm_opt_state_to_numpy(state: Dict[str, Any],
                          cfg: ModelConfig) -> Dict[str, Any]:
    """Inverse of `lm_opt_state_from_numpy`."""
    mu = state["mu"]
    return {"mu": None if mu is None else lm_view_to_numpy(mu, cfg),
            "step": tree_to_numpy(state["step"])}


def fed_from_numpy(x, y, n, x_val, y_val, group,
                   device: DeviceLike = "cuda") -> FederatedData:
    """The port's `FederatedData` from the reference's scenario arrays
    (images as f32; an LM population's integer tokens as int64)."""
    dev = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    i64 = lambda a: torch.tensor(np.asarray(a, np.int64), device=dev)
    xs = i64 if np.issubdtype(np.asarray(x).dtype, np.integer) else f32
    return FederatedData(xs(x), i64(y), f32(n), xs(x_val), i64(y_val),
                         i64(group))
