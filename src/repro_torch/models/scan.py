"""The reference's scanned parameter layout, its loss, and its flat view.

Counterpart of `repro/models/scan.py` (`layer_grouping`,
`stack_layer_params`, `unstack_layer_params`, `loss_fn`).  The
reference regroups ``params["layers"]`` into a repeating block of
``period`` sub-layers, stacked across the groups (``prefix_layers``, a
list, and ``scan_layers``, a tuple of ``period`` trees whose leaves have
a leading groups dim), and drives the block by ``lax.scan``.  Here the
scan is a Python loop over the groups, with the same numerics: each
group's slice of the stacked leaves runs through the block with the
slot's representative layer index, as the scan body does; a hybrid's
attention slot runs the shared attention block (``shared_attn``, outside
the stack), as the reference's `_make_body` passes it.  ``remat``
(the reference's ``jax.checkpoint`` of the body) is not ported: it
raises, naming ROADMAP.md Queue 1 item 18.

The round engine keeps one flat dict of tensors with sorted keys
(`core.similarity.flatten_pytree`, `core.distributed._flat`), while the
reference flattens its scanned tree by `jax.tree_util.tree_leaves`.
`flat_params` gives the tree a flat-key view whose keys sort in
``tree_leaves``' order (dict keys joined by ``"."``, which sorts below
every character of a key; sequence indices zero-padded), so Θ's rows,
Δ, the mix's leaves and the codec's rows line up coordinate for
coordinate with the reference's; `nest_params` re-nests it.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (_block_apply, _ce_from_hidden,
                                            _embed_inputs, add_aux,
                                            check_family)

ITEM_18 = "not ported yet: ROADMAP.md Queue 1 item 18"


def layer_grouping(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prefix, period, n_groups): layers n_prefix..L run in pattern
    blocks of ``period`` sub-layers."""
    n_pre = 0
    if cfg.moe is not None and cfg.moe.n_dense_layers:
        n_pre = cfg.moe.n_dense_layers
    if cfg.family == "hybrid":
        period = cfg.hybrid.attn_every
    elif cfg.attn is not None:
        period = len(cfg.attn.layer_pattern)
    else:
        period = 1
    rest = cfg.n_layers - n_pre
    while rest % period:      # fall back to a period that divides
        period -= 1
    return n_pre, period, rest // period


def _map(fn, *trees):
    """``fn`` on the matching tensors of same-structured nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(params: Dict[str, Any], cfg: ModelConfig
                       ) -> Dict[str, Any]:
    """``params["layers"]`` regrouped: ``prefix_layers`` (a list) and
    ``scan_layers`` (a tuple of ``period`` trees, each leaf stacked to a
    leading n_groups dim)."""
    n_pre, period, groups = layer_grouping(cfg)
    layers = params["layers"]
    rest = layers[n_pre:]
    slots = tuple(
        _map(lambda *ls: torch.stack(ls),
             *[rest[g * period + j] for g in range(groups)])
        for j in range(period))
    out = {k: v for k, v in params.items() if k != "layers"}
    out["prefix_layers"] = list(layers[:n_pre])
    out["scan_layers"] = slots
    return out


def unstack_layer_params(params: Dict[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """Inverse of `stack_layer_params`."""
    _, period, groups = layer_grouping(cfg)
    layers = list(params["prefix_layers"])
    slots = params["scan_layers"]
    for g in range(groups):
        for j in range(period):
            layers.append(_map(lambda leaf: leaf[g], slots[j]))
    out = {k: v for k, v in params.items()
           if k not in ("prefix_layers", "scan_layers")}
    out["layers"] = layers
    return out


def forward_hidden(params: Dict[str, Any], cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scanned stack's forward up to (not including) the final norm
    and unembed."""
    if remat:
        raise NotImplementedError(f"remat is {ITEM_18}")
    check_family(cfg)
    n_pre, period, groups = layer_grouping(cfg)
    x, prefix_len = _embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.get("prefix_layers", [])):
        x, aux, _ = _block_apply(lp, cfg, i, x, 0,
                                 shared=params.get("shared_attn"),
                                 prefix_len=prefix_len)
        aux_total = add_aux(aux_total, aux)
    slots = params["scan_layers"]
    for g in range(groups):
        for j in range(period):
            # the slot's representative index, as the scan body's
            x, aux, _ = _block_apply(_map(lambda leaf: leaf[g], slots[j]),
                                     cfg, n_pre + j, x, 0,
                                     shared=params.get("shared_attn"),
                                     prefix_len=prefix_len)
            aux_total = add_aux(aux_total, aux)
    return x, aux_total


def loss_fn(params: Dict[str, Any], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = False):
    """Scanned next-token CE loss (mirrors `transformer.loss_fn`)."""
    hidden, aux = forward_hidden(params, cfg, batch, remat=remat)
    ce = _ce_from_hidden(params, cfg, hidden, batch["tokens"])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# ---------------------------------------------------------------------------
# the flat-key view


def flat_params(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / lists / tuples -> {dotted key: leaf}, the keys in
    `jax.tree_util.tree_leaves`' order when sorted (an empty sequence
    has no leaves, and no key)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        width = len(str(max(len(tree) - 1, 0)))
        items = [(str(i).zfill(width), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}.{k}" if prefix else k))
    return out


def _nest(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = root
        *path, last = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def seqs(node):
        if not isinstance(node, dict):
            return node
        kids = {k: seqs(v) for k, v in node.items()}
        if kids and all(k.isdigit() for k in kids):
            return [kids[k] for k in sorted(kids, key=int)]
        return kids

    return seqs(root)


def nest_params(flat: Dict[str, Any]) -> Any:
    """Inverse of `flat_params`.  A tree that holds ``scan_layers`` gets
    the scanned layout's containers as the reference has them:
    ``prefix_layers`` a list (empty when it has no layer, so no key),
    ``scan_layers`` a tuple.  A flat dict of plain keys comes back as it
    is."""
    tree = _nest(flat)
    if "scan_layers" in tree:
        tree.setdefault("prefix_layers", [])
        tree["scan_layers"] = tuple(tree["scan_layers"])
    return tree
