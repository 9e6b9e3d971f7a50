"""Partitioning rules: params, optimizer state, batches and caches -> specs.

Counterpart of `repro/launch/sharding.py`, rule for rule, as pure
metadata.  A spec (`Spec`, a tuple) has one entry a dim: None
(replicated), an axis name, or a tuple of axis names; it plays the part
of JAX's `PartitionSpec` (``P("data", None)`` is ``Spec("data", None)``,
equal to the tuple ``("data", None)``, and ``P()`` is ``Spec()``).  The
rules:

- tensor parallel over ``"model"``: attention heads (or head_dim when the
  head count does not divide), the MoE expert dim, the FFN hidden dim and
  the vocab, chosen leaf by leaf by name with divisibility fallbacks;
- FSDP over ``"data"`` for the configs whose clients span a pod
  (``fl_client_axis == "pod"``), and the ``serve_tp`` 2-D layout when
  such a config serves with it;
- the FL client dim (the leading axis of client-stacked params) over the
  client axes; a scan-stacked group dim replicated.

A leaf's path names are its dict keys and NamedTuple field names, as
JAX's ``DictKey`` and ``GetAttrKey`` give them (list and tuple indices
carry no name).

The port runs only the ``(P, 1)`` layout: one rank a card, each rank
holding its clients' whole parameters (`fl/placement/mesh.py`), so
``"model"`` has size 1 and every feature dim stays whole.  The other
layouts are what a GSPMD deployment would hold; the planner
(`launch/dryrun.py`) uses them only to reckon bytes a device.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh, client_axes, data_axes


def _entry(d):
    """A dim's entry as `PartitionSpec` keeps it: a tuple of one name is
    the name, an empty tuple None."""
    if isinstance(d, tuple):
        return None if not d else d[0] if len(d) == 1 else d
    return d


class Spec(tuple):
    """One leaf's partition spec: an entry a dim (None, an axis name, or
    a tuple of axis names), normalized as `PartitionSpec` normalizes."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(_entry(d) for d in dims))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


# dims preferred for "model" sharding, per param name (indices into the
# leaf's *base* shape, tried in order; first divisible wins)
_MODEL_DIM_PREF = {
    "embed": (0, 1), "pos_emb": (1,), "lm_head": (1, 0),
    "wq": (1, 2, 0), "wk": (1, 2, 0), "wv": (1, 2, 0), "wo": (0, 1),
    "wq_a": (1, 0), "wq_b": (1, 0), "wkv_a": (1, 0), "wkv_b": (1, 0),
    "up": (1, 0), "gate": (1, 0), "down": (0, 1),
    "router": (1,),
    "w_up": (0, 2), "w_gate": (0, 2), "w_down": (0, 1),
    "in_proj": (1, 0), "out_proj": (0, 1),
    "vision_proj": (1, 0),
    "cross_k": (), "cross_v": (),
}
_REPLICATED = {"scale", "bias", "conv_w", "conv_b", "A_log", "D", "dt_bias",
               "norm_scale", "q_norm", "kv_norm", "q_scale", "k_scale"}


def map_with_path(fn, tree: Any, names: Tuple[str, ...] = ()) -> Any:
    """``fn(names, leaf)`` on every leaf of nested dicts, lists, tuples
    and NamedTuples (None kept), the same containers back; ``names`` the
    dict keys and field names on the way to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, names + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, names) for v in tree)
    return fn(names, tree)


def _prod(sizes) -> int:
    return int(np.prod(sizes))


def _base_spec(name: str, shape: Tuple[int, ...], mesh: Mesh,
               fsdp: bool, serve_tp: bool = False) -> list:
    """Per-dim axis assignment for an unstacked param leaf."""
    spec: List[Any] = [None] * len(shape)
    msize = mesh.shape["model"]
    if name in _REPLICATED or not shape:
        return spec
    prefs = _MODEL_DIM_PREF.get(name, tuple(np.argsort(shape)[::-1]))
    model_dim = None
    for d in prefs:
        if d < len(shape) and shape[d] % msize == 0:
            model_dim = d
            break
    if model_dim is not None:
        spec[model_dim] = "model"
    if serve_tp and "data" in mesh.axis_names:
        # weight-stationary 2-D TP: widen the TP dim to ("data", "model")
        # when jointly divisible, else put "data" on the next preferred
        # dim; weights never move, activations all-reduce
        dsize = mesh.shape["data"]
        if model_dim is not None and shape[model_dim] % (msize * dsize) == 0:
            spec[model_dim] = ("data", "model")
        else:
            for d in list(prefs) + sorted(range(len(shape)),
                                          key=lambda d: -shape[d]):
                if d < len(shape) and d != model_dim and \
                        shape[d] % dsize == 0 and shape[d] >= dsize:
                    spec[d] = "data"
                    break
    elif fsdp and "data" in mesh.axis_names:
        dsize = mesh.shape["data"]
        # the largest remaining divisible dim carries the FSDP shard
        order = sorted(range(len(shape)), key=lambda d: -shape[d])
        for d in order:
            if d != model_dim and shape[d] % dsize == 0 and shape[d] >= dsize:
                spec[d] = "data"
                break
    return spec


def param_specs(params: Any, cfg: ModelConfig, mesh: Mesh, *,
                client_stacked: bool = False, serve: bool = False) -> Any:
    """The spec tree of (client-stacked or not, scan-stacked or not)
    params, or of an optimizer state that mirrors them."""
    serve_tp = serve and cfg.serve_tp and cfg.fl_client_axis == "pod"
    fsdp = cfg.fl_client_axis == "pod" and not serve_tp
    caxes = client_axes(mesh, cfg)
    # client-per-device placement: the client dim consumes every axis, so
    # the weights' feature dims stay replicated
    replicate_inner = client_stacked and "model" in caxes

    def spec(names, leaf):
        name = names[-1] if names else ""
        prefix: List[Any] = []
        skip = 0
        if client_stacked:
            prefix.append(caxes if caxes else None)
            skip += 1
        if "scan_layers" in names:
            prefix.append(None)
            skip += 1
        base_shape = tuple(leaf.shape[skip:])
        if name == "step" or leaf.dim() == 0:
            return Spec()
        inner = [None] * len(base_shape) if replicate_inner else \
            _base_spec(name, base_shape, mesh, fsdp, serve_tp)
        return Spec(*prefix, *inner)

    return map_with_path(spec, params)


def batch_specs(batch: Any, cfg: ModelConfig, mesh: Mesh, *,
                client_dim: bool = False) -> Any:
    """Batch sharding: a leading client dim over the client axes;
    otherwise the batch dim over all data axes.  Batch-1 leaves
    (long_500k) replicate."""
    caxes = client_axes(mesh, cfg)
    daxes = data_axes(mesh)

    def spec(names, leaf):
        dims: List[Any] = [None] * leaf.dim()
        if client_dim:
            if caxes and leaf.shape[0] % _prod(
                    [mesh.shape[a] for a in caxes]) == 0:
                dims[0] = caxes
            # the per-client batch dim over the remaining data axes (pod
            # mode)
            rem = tuple(a for a in daxes if a not in caxes)
            if rem and leaf.dim() > 1 and \
                    leaf.shape[1] % _prod([mesh.shape[a] for a in rem]) == 0:
                dims[1] = rem if len(rem) > 1 else rem[0]
        else:
            total = _prod([mesh.shape[a] for a in daxes])
            if leaf.shape[0] % total == 0 and leaf.shape[0] >= total:
                dims[0] = daxes if len(daxes) > 1 else daxes[0]
        return Spec(*dims)

    return map_with_path(spec, batch)


def cache_specs(caches: Any, cfg: ModelConfig, mesh: Mesh, *,
                batch: int, seq_shard: bool = False) -> Any:
    """KV and SSM cache sharding for serving.

    The batch dim over the data axes when divisible; otherwise (long_500k,
    batch 1) the sequence dim over data and the heads or feature dims over
    model.  ``seq_shard`` (the ``serve_tp`` layout of the configs whose
    clients span a pod): the batch replicated and the cache's sequence dim
    over ``"data"``, beside weights sharded over ("data", "model")."""
    daxes = data_axes(mesh)
    dtotal = _prod([mesh.shape[a] for a in daxes])
    msize = mesh.shape["model"]
    batch_shardable = (not seq_shard) and batch % dtotal == 0 \
        and batch >= dtotal
    d_for_batch = daxes if len(daxes) > 1 else daxes[0]

    def spec(names, leaf):
        name = names[-1] if names else ""
        if leaf.dim() == 0:
            return Spec()
        # scan-stacked caches carry a leading (n_groups,) dim, replicated
        skip = 1 if "scan" in names else 0
        b_dim, s_dim = skip, skip + 1
        dims: List[Any] = [None] * leaf.dim()
        if batch_shardable and leaf.dim() > b_dim:
            dims[b_dim] = d_for_batch
        if name == "pos":                       # (B, C) int positions
            if not batch_shardable and leaf.dim() > s_dim and \
                    leaf.shape[s_dim] % dtotal == 0:
                dims[s_dim] = d_for_batch
            return Spec(*dims)
        # feature dims: heads / features over model, seq over data
        if name in ("k", "v", "cross_k", "cross_v", "conv", "state"):
            # a trailing dim divisible by the model size (heads, ranks, hd)
            for d in range(leaf.dim() - 1, s_dim, -1):
                if leaf.shape[d] % msize == 0 and leaf.shape[d] >= msize:
                    dims[d] = "model"
                    break
            if not batch_shardable and leaf.dim() > s_dim and \
                    name != "state" and leaf.shape[s_dim] % dtotal == 0 \
                    and leaf.shape[s_dim] >= dtotal:
                dims[s_dim] = d_for_batch     # the seq / window dim
        return Spec(*dims)

    return map_with_path(spec, caches)


def to_shardings(specs: Any, mesh: Mesh) -> Any:
    """Each spec paired with the mesh, ``(mesh, spec)``: a record of where
    a GSPMD deployment would place the leaf, not a placement."""
    def pair(tree):
        if tree is None:
            return None
        if isinstance(tree, Spec):
            return (mesh, tree)
        if isinstance(tree, dict):
            return {k: pair(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(pair(v) for v in tree))
        return type(tree)(pair(v) for v in tree)
    return pair(specs)

