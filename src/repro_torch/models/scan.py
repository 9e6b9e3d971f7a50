"""The reference's scanned layout: its training loss (with ``remat``),
its serving path, and its flat view.

Counterpart of `repro/models/scan.py` (`layer_grouping`,
`stack_layer_params`, `unstack_layer_params`, `stack_caches`,
`forward_hidden`, `loss_fn`, `prefill`, `decode_step`).  The reference
regroups ``params["layers"]`` into a repeating block of ``period``
sub-layers, stacked across the groups (``prefix_layers``, a list, and
``scan_layers``, a tuple of ``period`` trees whose leaves have a leading
groups dim), and drives the block by ``lax.scan``.  Here the scan is a
Python loop over the groups, with the same numerics: each group's slice
of the stacked leaves runs through the block with the slot's
representative layer index, as the scan body (`_make_body`) does; a
hybrid's attention slot runs the shared attention block
(``shared_attn``, outside the stack), as the reference passes it.

``remat=True`` is the reference's ``jax.checkpoint`` of the scan body: a
group's forward keeps only its inputs, and its backward runs the group
again.  `torch.utils.checkpoint` does not compose with `torch.func`
(the round engine takes ``vmap(grad(loss))``), so the group runs inside
`_Remat`, an `autograd.Function` with ``setup_context`` and a generated
vmap rule, whose backward recomputes the group through `torch.func.vjp`.
Its forward runs the very ops of ``remat=False``, so the loss is the
same bits.

Serving (`prefill`, `decode_step`) takes the caches in `stack_caches`'
layout: ``{"prefix": list, "scan": tuple of period slots}``, each slot
the same NamedTuple (`KVCache`, `SSMCache`) with its fields stacked to a
leading groups dim.  A group's cache is the slot's ``[g]`` view.  An
attention ring is written in place (`attention._cache_update`), so the
write lands in the stacked tensor and the slot comes back as it went in.
An SSM layer's cache is replaced every step and never written in place
(its old tensors may still be read by the caller or an earlier step), so
a slot whose group caches came back new is stacked anew, out of place.

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

from typing import Any, Callable, Dict, List, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (_block_apply, _ce_from_hidden,
                                            _embed_inputs, _unembed, add_aux,
                                            check_family, lockstep_position)


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
    """``fn`` on the matching tensors of same-structured nested dicts and
    NamedTuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_map(fn, *(x[i] for x in trees))
                         for i in range(len(t))))
    return fn(*trees)


def _regroup(items: List[Any], cfg: ModelConfig) -> Tuple[list, tuple]:
    """Per-layer items -> (the prefix list, a tuple of ``period`` slots,
    each the groups' items stacked to a leading n_groups dim)."""
    n_pre, period, groups = layer_grouping(cfg)
    rest = items[n_pre:]
    slots = tuple(
        _map(lambda *ls: torch.stack(ls),
             *[rest[g * period + j] for g in range(groups)])
        for j in range(period))
    return list(items[:n_pre]), slots


def _group(slot: Any, g: int) -> Any:
    """Group g's slice of a stacked slot (views of its tensors)."""
    return _map(lambda leaf: leaf[g], slot)


def _ungroup(prefix: list, slots: tuple, cfg: ModelConfig) -> list:
    """Inverse of `_regroup`: one item a layer, in layer order (the
    groups' items views of the stacked slots)."""
    _, period, groups = layer_grouping(cfg)
    return list(prefix) + [_group(slots[j], g) for g in range(groups)
                           for j in range(period)]


def stack_layer_params(params: Dict[str, Any], cfg: ModelConfig
                       ) -> Dict[str, Any]:
    """``params["layers"]`` regrouped: ``prefix_layers`` (a list) and
    ``scan_layers`` (a tuple of ``period`` trees, each leaf stacked to a
    leading n_groups dim)."""
    prefix, slots = _regroup(params["layers"], cfg)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["prefix_layers"] = prefix
    out["scan_layers"] = slots
    return out


def unstack_layer_params(params: Dict[str, Any], cfg: ModelConfig
                         ) -> Dict[str, Any]:
    """Inverse of `stack_layer_params`."""
    out = {k: v for k, v in params.items()
           if k not in ("prefix_layers", "scan_layers")}
    out["layers"] = _ungroup(params["prefix_layers"], params["scan_layers"],
                             cfg)
    return out


def stack_caches(caches: List[Any], cfg: ModelConfig) -> Dict[str, Any]:
    """`transformer.make_caches`' per-layer caches in the scanned layout:
    ``{"prefix": list, "scan": tuple of period slots}``, each slot the
    layer's NamedTuple with every field stacked over the groups."""
    prefix, slots = _regroup(caches, cfg)
    return {"prefix": prefix, "scan": slots}


def unstack_caches(caches: Dict[str, Any], cfg: ModelConfig) -> List[Any]:
    """Inverse of `stack_caches`: one cache a layer, in layer order (the
    groups' caches views of the stacked slots)."""
    return _ungroup(caches["prefix"], caches["scan"], cfg)


# ---------------------------------------------------------------------------
# training: the scanned forward and its loss, with remat


class _Remat(torch.autograd.Function):
    """``fn(*tensors)`` whose forward keeps only ``tensors`` and whose
    backward runs ``fn`` again under `torch.func.vjp`: the reference's
    ``jax.checkpoint``, in a form that `torch.func.grad` and
    `torch.func.vmap` take."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn: Callable, *tensors):
        outs = fn(*tensors)
        # an output that is an input as it is (a dense group's aux) is
        # returned as a copy: an autograd.Function may not alias its inputs
        return tuple(o.clone() if any(o is t for t in tensors) else o
                     for o in outs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        _, vjp_fn = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
        # `torch.func.grad` records its backward for a higher order; the
        # gradients come out detached, so the recomputed group's graph is
        # freed as soon as they are out (no gradient of a gradient)
        return (None, *(g.detach() for g in vjp_fn(grads)))


def _group_fn(cfg: ModelConfig, n_pre: int, period: int, prefix_len: int,
              spec) -> Callable:
    """(x, aux, *leaves) -> (x, aux) over one group: the period's blocks
    with the slot's representative indices n_pre + j, each block's aux
    added to the running aux in layer order, as the unrolled loop adds
    it.  ``leaves`` flatten (the group's slices, the shared block or
    {}) by ``spec``."""
    def fn(x, aux, *leaves):
        slices, shared = pytree.tree_unflatten(list(leaves), spec)
        for j in range(period):
            x, a, _ = _block_apply(slices[j], cfg, n_pre + j, x, 0,
                                   shared=shared or None,
                                   prefix_len=prefix_len)
            aux = add_aux(aux, a)
        return x, aux
    return fn


def forward_hidden(params: Dict[str, Any], cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scanned stack's forward up to (not including) the final norm
    and unembed; ``remat`` recomputes each group in the backward
    (`_Remat`) instead of keeping its activations."""
    check_family(cfg)
    n_pre, period, groups = layer_grouping(cfg)
    x, prefix_len = _embed_inputs(params, cfg, batch)
    shared = params.get("shared_attn")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.get("prefix_layers", [])):
        x, aux, _ = _block_apply(lp, cfg, i, x, 0, shared=shared,
                                 prefix_len=prefix_len)
        aux_total = add_aux(aux_total, aux)
    slots = params["scan_layers"]
    for g in range(groups):
        leaves, spec = pytree.tree_flatten(
            ([_group(slots[j], g) for j in range(period)], shared or {}))
        fn = _group_fn(cfg, n_pre, period, prefix_len, spec)
        if remat:
            x, aux_total = _Remat.apply(fn, x, aux_total, *leaves)
        else:
            x, aux_total = fn(x, aux_total, *leaves)
    return x, aux_total


def loss_fn(params: Dict[str, Any], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = False):
    """Scanned next-token CE loss (mirrors `transformer.loss_fn`)."""
    hidden, aux = forward_hidden(params, cfg, batch, remat=remat)
    ce = _ce_from_hidden(params, cfg, hidden, batch["tokens"])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# ---------------------------------------------------------------------------
# serving


def _restack(slot: Any, pairs: List[Tuple[Any, Any]]) -> Any:
    """A slot after its groups' steps: ``pairs`` the (given, returned)
    cache of each group.  Rings come back as the caches they were
    (written in place, into the stack): the slot as it is.  Otherwise
    (an SSM layer's new caches) the returned caches stacked anew, so
    nothing the caller holds is overwritten."""
    if all(new is old for old, new in pairs):
        return slot
    return _map(lambda *ts: torch.stack(ts), *[new for _, new in pairs])


def _serve_stack(params, cfg: ModelConfig, x: torch.Tensor, start: int,
                 caches: Dict[str, Any], *, decode: bool, prefix_len: int,
                 long_context: bool):
    """The prefix layers, then each group's slice of every slot through
    `_block_apply` at the slot's representative index (the reference's
    scan body, `_make_body`).  Returns (x, the new caches)."""
    n_pre, period, groups = layer_grouping(cfg)
    shared = params.get("shared_attn")
    kw = dict(shared=shared, decode=decode, prefix_len=prefix_len,
              long_context=long_context)
    new_prefix = []
    for i, (lp, c) in enumerate(zip(params["prefix_layers"],
                                    caches["prefix"])):
        x, _, c = _block_apply(lp, cfg, i, x, start, cache=c, **kw)
        new_prefix.append(c)
    slots, cslots = params["scan_layers"], caches["scan"]
    pairs: List[list] = [[] for _ in range(period)]
    for g in range(groups):
        for j in range(period):
            c = _group(cslots[j], g)
            x, _, c2 = _block_apply(_group(slots[j], g), cfg, n_pre + j, x,
                                    start, cache=c, **kw)
            pairs[j].append((c, c2))
    new_scan = tuple(_restack(cslots[j], pairs[j]) for j in range(period))
    return x, {"prefix": new_prefix, "scan": new_scan}


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            caches: Dict[str, Any], *, long_context: bool = False):
    """Scanned prefill from position 0; ``caches`` from `stack_caches`.
    Returns (last-position logits (B, 1, V) f32, the new caches)."""
    check_family(cfg)
    x, prefix_len = _embed_inputs(params, cfg, batch)
    x, caches = _serve_stack(params, cfg, x, 0, caches, decode=False,
                             prefix_len=prefix_len,
                             long_context=long_context)
    return _unembed(params, cfg, x[:, -1:]), caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                caches: Dict[str, Any], pos: Union[int, torch.Tensor], *,
                long_context: bool = False):
    """Scanned one-token decode step.  token (B, 1); pos the lockstep
    position (an int, or a (B,) tensor of equal entries: one host read).
    Returns (logits (B, 1, V) f32, the new caches)."""
    check_family(cfg)
    p = lockstep_position(pos)
    x, _ = _embed_inputs(params, cfg, {"tokens": token}, p)
    x, caches = _serve_stack(params, cfg, x, p, caches, decode=True,
                             prefix_len=0, long_context=long_context)
    return _unembed(params, cfg, x), caches


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
