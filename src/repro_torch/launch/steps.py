"""Step builders: the federated train step and the serving steps, and the
cases the planner plans.

Counterpart of `repro/launch/steps.py`.  `build_train_step` is one
federated round at mesh scale, as the reference's:

  1. every client (the leading dim of the client-stacked params) takes
     one local SGD step on its batch: `torch.func.vmap` of the loss's
     gradient over the clients, the per-client batch optionally cut into
     ``microbatch`` slices whose gradients accumulate in f32;
  2. the user-centric aggregation mixes the client models through
     `core.distributed.mix_schedule` on the mesh's process group (one
     process alone: `ONE_PROCESS`, no collective), over the flat-key
     view (`models.scan.flat_params`): one launch of the Y = W Θ kernel
     on the card.  ``w`` is (k, m) (k = 1 FedAvg, k = m unicast UCFL,
     1 < k < m streams) and ``assignment`` maps clients to streams.

The serving steps are single-model prefill and decode: the scanned
`models/scan.py` path (`stack_caches`, `prefill`, `decode_step`), or the
unscanned one for the audio family and under ``loop``.

`build_train_case`, `build_prefill_case` and `build_decode_case` return a
`TrainCase`: the step function, its arguments as ``meta`` tensors (the
reference's ``ShapeDtypeStruct``s: shapes and dtypes, no data), the spec
trees of `launch/sharding.py` paired with the mesh in place of the
reference's shardings, ``donate_argnums`` as metadata, and the
reference's ``meta`` dict.  The port's mesh holds one rank a card, each
with its clients' whole params; a case's arguments are this rank's rows.
A decode case takes its position as an int (the last cache slot): a
(B,) tensor would be read back to the host (`lockstep_position`), which
``meta`` tensors cannot do.  The planner (`launch/dryrun.py`) runs the
cases on ``meta``; a caller runs them on real tensors of the same shapes
(`sample_batch`, `init_stacked_params`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import ONE_PROCESS, mix_schedule
from repro_torch.launch.mesh import Mesh, client_axes, n_clients
from repro_torch.launch.sharding import (Spec, batch_specs, cache_specs,
                                         param_specs, to_shardings)
from repro_torch.models import scan as scan_mod
from repro_torch.models import transformer as T
from repro_torch.optim import apply_updates, sgd


# ---------------------------------------------------------------------------
# shapes


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode
    long_context: bool = False


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode",
                            long_context=True),
}


def _use_scan(cfg: ModelConfig) -> bool:
    return cfg.family != "audio"


def _loss_fn(cfg: ModelConfig, *, remat: bool) -> Callable:
    """(params, batch) -> (loss, metrics) over the layout
    `init_model_params` gives."""
    if _use_scan(cfg):
        return lambda p, b: scan_mod.loss_fn(p, cfg, b, remat=remat)
    return lambda p, b: T.loss_fn(p, cfg, b)


def init_model_params(gen: torch.Generator, cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """Single-model params on ``device`` (default ``gen.device``; ``meta``
    for planning), in the scanned layout when applicable."""
    params = T.init_params(gen, cfg, device=device or gen.device)
    if _use_scan(cfg):
        params = scan_mod.stack_layer_params(params, cfg)
    return params


def _stack(tree: Any, m: int) -> Any:
    if isinstance(tree, dict):
        return {k: _stack(v, m) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stack(v, m) for v in tree)
    return tree[None].expand((m,) + tuple(tree.shape)).clone()


def init_stacked_params(gen: torch.Generator, cfg: ModelConfig, m: int,
                        device=None) -> Dict[str, Any]:
    """Client-stacked params: every leaf gains a leading (m,) dim."""
    return _stack(init_model_params(gen, cfg, device), m)


def init_stacked_params_loop(gen: torch.Generator, cfg: ModelConfig, m: int,
                             device=None) -> Dict[str, Any]:
    """As `init_stacked_params` but without scan-stacking (the loop
    path)."""
    return _stack(T.init_params(gen, cfg, device=device or gen.device), m)


def make_optimizer(cfg: ModelConfig):
    """The paper's optimizer (SGD η = 0.1, β = 0.9, momentum in the param
    dtype); a config whose clients span a pod drops momentum."""
    if cfg.fl_client_axis == "pod":
        return sgd(0.1, momentum=0.0)
    return sgd(0.1, momentum=0.9, state_dtype="param")


def init_opt_state(opt, params: Dict[str, Any]) -> Dict[str, Any]:
    """``opt.init`` over the flat-key view, its ``mu`` re-nested to the
    params' layout (the reference's ``{"mu": tree or None, "step"}``)."""
    state = opt.init(scan_mod.flat_params(params))
    mu = state["mu"]
    return {"mu": None if mu is None else scan_mod.nest_params(mu),
            "step": state["step"]}


# ---------------------------------------------------------------------------
# batches


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_struct(cfg: ModelConfig, shape: InputShape, m: int,
                       tok_dtype=torch.int32) -> Dict[str, torch.Tensor]:
    """``meta`` tensors of a train batch: (m, global_batch / m, ...)."""
    b = shape.global_batch // m
    s = shape.seq_len
    batch = {}
    if cfg.family == "vlm":
        nv = cfg.vision.n_tokens
        batch["vision_embeds"] = _meta((m, b, nv, cfg.vision.embed_dim),
                                       cfg.cdtype)
        batch["tokens"] = _meta((m, b, s - nv), tok_dtype)
    elif cfg.family == "audio":
        batch["audio_embeds"] = _meta((m, b, cfg.encoder.n_ctx, cfg.d_model),
                                      cfg.cdtype)
        batch["tokens"] = _meta((m, b, s), tok_dtype)
    else:
        batch["tokens"] = _meta((m, b, s), tok_dtype)
    return batch


def serve_batch_struct(cfg: ModelConfig, shape: InputShape
                       ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors of a serving batch: (global_batch, ...)."""
    b, s = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.family == "vlm":
        nv = cfg.vision.n_tokens
        batch["vision_embeds"] = _meta((b, nv, cfg.vision.embed_dim),
                                       cfg.cdtype)
        batch["tokens"] = _meta((b, s - nv), torch.int32)
    elif cfg.family == "audio":
        batch["audio_embeds"] = _meta((b, cfg.encoder.n_ctx, cfg.d_model),
                                      cfg.cdtype)
        batch["tokens"] = _meta((b, s), torch.int32)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
    return batch


def sample_batch(gen: torch.Generator, struct: Dict[str, torch.Tensor],
                 vocab: int) -> Dict[str, torch.Tensor]:
    """A random batch of a struct's shapes and dtypes on ``gen.device``:
    tokens uniform in [0, vocab), the rest N(0, 1)."""
    out = {}
    for k, s in struct.items():
        if k == "tokens":
            out[k] = torch.randint(0, vocab, tuple(s.shape), generator=gen,
                                   dtype=s.dtype, device=gen.device)
        else:
            out[k] = torch.randn(tuple(s.shape), generator=gen,
                                 device=gen.device).to(s.dtype)
    return out


# ---------------------------------------------------------------------------
# train step


@dataclass
class TrainCase:
    fn: Callable
    args: Tuple[Any, ...]           # meta tensors (and an int position)
    in_shardings: Tuple[Any, ...]   # (mesh, Spec) records
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    meta: Dict[str, Any]


def build_train_step(cfg: ModelConfig, mesh: Mesh, *, n_streams: int = 0,
                     schedule: str = "gspmd", remat: bool = True,
                     mix_every: int = 1, loop: bool = False,
                     microbatch: int = 1) -> Callable:
    """Returns ``train_step(params, opt_state, batch, w, assignment)`` ->
    (params, opt_state, {"loss", "ce"}) over this rank's client rows.
    ``loop`` takes the unscanned per-layer layout (the planner's cost
    extrapolation; numerically the same).  ``microbatch`` > 1 accumulates
    the gradients of that many slices of the per-client batch in f32, then
    averages them: the activation-memory knob.  The loss is the mean over
    this rank's clients."""
    caxes = client_axes(mesh, cfg)
    opt = make_optimizer(cfg)
    loss_fn = (lambda p, b: T.loss_fn(p, cfg, b)) if loop else \
        _loss_fn(cfg, remat=remat)
    nest = scan_mod.nest_params

    def client_grads(flat, batch):
        """Each client's (grads, loss, metrics): vmap over the rows."""
        def one(p, b):
            return grad_and_value(lambda q: loss_fn(nest(q), b),
                                  has_aux=True)(p)
        g, (losses, metrics) = vmap(one)(flat, batch)
        return g, losses, metrics

    def grads_of(flat, batch):
        if microbatch == 1:
            g, losses, metrics = client_grads(flat, batch)
            return losses.sum(), metrics, g
        # (m, b, ...) -> microbatch slices (m, b / microbatch, ...)
        def piece(leaf, i):
            mm, b = leaf.shape[:2]
            return leaf.reshape((mm, microbatch, b // microbatch)
                                + tuple(leaf.shape[2:]))[:, i]
        g_acc = {k: torch.zeros(v.shape, dtype=torch.float32,
                                device=v.device) for k, v in flat.items()}
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=next(iter(flat.values())).device)
        steps = []
        for i in range(microbatch):
            g, losses, metrics = client_grads(
                flat, {k: piece(v, i) for k, v in batch.items()})
            g_acc = {k: a + g[k].float() for k, a in g_acc.items()}
            loss_acc = loss_acc + losses.sum()
            steps.append(metrics)
        # a client's loss is a batch mean: average the slice means
        g = {k: (a / microbatch).to(flat[k].dtype) for k, a in g_acc.items()}
        metrics = {k: torch.stack([s[k] for s in steps]).mean()
                   for k in steps[0]}
        return loss_acc / microbatch, metrics, g

    group = ONE_PROCESS if mesh.group is None else mesh.group

    def mix(flat, w, assignment):
        if schedule == "gspmd" or not caxes:
            # square w already has one row per client: skip the take
            assignment = None if w.shape[0] == w.shape[1] else assignment
        return mix_schedule(group, flat, w, assignment,
                            schedule=schedule if caxes else "gspmd")

    def train_step(params, opt_state, batch, w, assignment):
        flat = scan_mod.flat_params(params)
        loss, metrics, grads = grads_of(flat, batch)
        mu = opt_state["mu"]
        state = {"mu": None if mu is None else scan_mod.flat_params(mu),
                 "step": opt_state["step"]}
        updates, state = opt.update(grads, state, flat)
        flat = mix(apply_updates(flat, updates), w, assignment)
        mm = next(iter(flat.values())).shape[0]
        opt_state = {"mu": None if state["mu"] is None
                     else nest(state["mu"]), "step": state["step"]}
        return nest(flat), opt_state, {"loss": loss / mm,
                                       "ce": torch.mean(metrics["ce"])}

    return train_step


def build_train_case(cfg: ModelConfig, mesh: Mesh, shape: InputShape, *,
                     n_streams: int = 4, schedule: str = "gspmd",
                     remat: bool = True, loop: bool = False,
                     microbatch: int = 1) -> TrainCase:
    """A train_4k-style case: this rank's client-stacked params, their
    optimizer state and batch, ``w`` (k, m) and ``assignment`` (m,)."""
    m = n_clients(mesh, cfg)
    mm = max(1, m // mesh.size)
    k = max(1, min(n_streams, m))
    opt = make_optimizer(cfg)
    init = init_stacked_params_loop if loop else init_stacked_params
    params = init(torch.Generator().manual_seed(0), cfg, mm, device="meta")
    opt_state = init_opt_state(opt, params)
    batch = train_batch_struct(cfg, shape, m)
    batch = {key: v[:mm] for key, v in batch.items()}
    w = _meta((k, m), torch.float32)
    assignment = _meta((m,), torch.int32)

    pspec = param_specs(params, cfg, mesh, client_stacked=True)
    ospec = param_specs(opt_state, cfg, mesh, client_stacked=True)
    bspec = batch_specs(batch, cfg, mesh, client_dim=True)
    fn = build_train_step(cfg, mesh, n_streams=k, schedule=schedule,
                          remat=remat, loop=loop, microbatch=microbatch)
    in_specs = (pspec, ospec, bspec, Spec(), Spec())
    out_specs = (pspec, ospec, None)
    return TrainCase(
        fn=fn, args=(params, opt_state, batch, w, assignment),
        in_shardings=to_shardings(in_specs, mesh),
        out_shardings=to_shardings(out_specs, mesh),
        donate_argnums=(0, 1),
        meta={"m_clients": m, "n_streams": k, "schedule": schedule,
              "microbatch": microbatch},
    )


# ---------------------------------------------------------------------------
# serve steps


def _cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    return shape.seq_len


def _serve_params(cfg: ModelConfig, loop: bool) -> Dict[str, Any]:
    gen = torch.Generator().manual_seed(0)
    if loop:
        return T.init_params(gen, cfg, device="meta")
    return init_model_params(gen, cfg, device="meta")


def _make_caches(cfg: ModelConfig, batch: int, shape: InputShape,
                 use_scan: bool, device) -> Any:
    caches = T.make_caches(cfg, batch, _cache_len(cfg, shape), cfg.cdtype,
                           long_context=shape.long_context, device=device)
    return scan_mod.stack_caches(caches, cfg) if use_scan else caches


def build_prefill_case(cfg: ModelConfig, mesh: Mesh, shape: InputShape,
                       *, loop: bool = False) -> TrainCase:
    """Prefill: (params, batch) -> (last logits, caches), the caches made
    on the batch's device inside the step."""
    long_ctx = shape.long_context
    use_scan = _use_scan(cfg) and not loop

    def prefill_fn(params, batch):
        bsz = batch["tokens"].shape[0]
        caches = _make_caches(cfg, bsz, shape, use_scan,
                              batch["tokens"].device)
        if use_scan:
            return scan_mod.prefill(params, cfg, batch, caches,
                                    long_context=long_ctx)
        return T.prefill(params, cfg, batch, caches, long_context=long_ctx)

    params = _serve_params(cfg, loop)
    batch = serve_batch_struct(cfg, shape)
    serve_tp = cfg.serve_tp and cfg.fl_client_axis == "pod"
    pspec = param_specs(params, cfg, mesh, client_stacked=False, serve=True)
    bspec = batch_specs(batch, cfg, mesh, client_dim=False)
    out_caches = _make_caches(cfg, shape.global_batch, shape, use_scan,
                              "meta")
    cspec = cache_specs(out_caches, cfg, mesh, batch=shape.global_batch,
                        seq_shard=serve_tp)
    return TrainCase(
        fn=prefill_fn, args=(params, batch),
        in_shardings=to_shardings((pspec, bspec), mesh),
        out_shardings=to_shardings((None, cspec), mesh),
        donate_argnums=(),
        meta={"kind": "prefill"},
    )


def build_decode_case(cfg: ModelConfig, mesh: Mesh, shape: InputShape,
                      *, loop: bool = False) -> TrainCase:
    """Decode: (params, caches, token, pos) -> (logits, caches).

    The cache stands for ``shape.seq_len`` tokens of context; under
    long_500k an attention config's is the sliding-window ring and an SSM
    config's the O(1) state.  ``pos`` is the last position, an int."""
    b = shape.global_batch
    long_ctx = shape.long_context
    use_scan = _use_scan(cfg) and not loop
    cache_len = _cache_len(cfg, shape)

    def decode_fn(params, caches, token, pos):
        if use_scan:
            return scan_mod.decode_step(params, cfg, token, caches, pos,
                                        long_context=long_ctx)
        return T.decode_step(params, cfg, token, caches, pos,
                             long_context=long_ctx)

    params = _serve_params(cfg, loop)
    caches = _make_caches(cfg, b, shape, use_scan, "meta")
    token = _meta((b, 1), torch.int32)
    pos = shape.seq_len - 1

    serve_tp = cfg.serve_tp and cfg.fl_client_axis == "pod"
    pspec = param_specs(params, cfg, mesh, client_stacked=False, serve=True)
    cspec = cache_specs(caches, cfg, mesh, batch=b, seq_shard=serve_tp)
    # token / pos batch-sharded like the caches; under the serve_tp layout
    # the batch is replicated and the cache sequence-sharded instead
    if serve_tp:
        tspec = {"t": Spec(), "p": Spec()}
    else:
        tspec = batch_specs({"t": token, "p": _meta((b,), torch.int32)},
                            cfg, mesh, client_dim=False)
    in_specs = (pspec, cspec, tspec["t"], tspec["p"])
    return TrainCase(
        fn=decode_fn, args=(params, caches, token, pos),
        in_shardings=to_shardings(in_specs, mesh),
        out_shardings=to_shardings((None, cspec), mesh),
        donate_argnums=(1,),
        meta={"kind": "decode", "cache_len": cache_len},
    )


def build_case(cfg: ModelConfig, mesh: Mesh, shape_name, **kw) -> TrainCase:
    """The case of an `INPUT_SHAPES` name (or of an `InputShape`)."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    if shape.kind == "train":
        return build_train_case(cfg, mesh, shape, **kw)
    loop = kw.get("loop", False)
    if shape.kind == "prefill":
        return build_prefill_case(cfg, mesh, shape, loop=loop)
    return build_decode_case(cfg, mesh, shape, loop=loop)

