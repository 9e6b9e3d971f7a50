"""Decoder stack of the dense, MoE, SSM and hybrid families: init, caches,
forward, prefill and decode.

Counterpart of `repro/models/transformer.py` for those families, in its
loop form (the reference's `models/scan.py` is numerically the loop's;
`convert.lm_params_from_numpy` unstacks its params):

    params          = init_params(gen, cfg, device=...)
    logits, aux     = forward(params, cfg, batch)
    loss, metrics   = loss_fn(params, cfg, batch)
    caches          = make_caches(cfg, batch, cache_len, dtype, device=...)
    logits, caches  = prefill(params, cfg, batch, caches)
    logits, caches  = decode_step(params, cfg, token, caches, pos)

Params are the reference's dict: ``embed`` (V, d), ``layers`` (a list of
``norm1``/``attn``/``norm2`` dicts with an ``mlp``, or a ``moe``
(`models/moe.py`) on a MoE layer: a MoE config's first
``n_dense_layers`` keep an ``mlp`` of ``dense_d_ff``), ``final_norm``
and, untied, ``lm_head`` (d, V).  A MoE layer's aux loss is summed into
`forward`'s and `loss_fn`'s aux.  An MLA config (deepseek-v3) keeps the
MLA projections in each layer's ``attn`` and a ring of the compressed
latent a layer (`models/attention.py`).  An SSM layer (`cfg.layer_kind`,
the ssm family's every layer, the hybrid's all but every ``attn_every``-th)
holds ``norm1`` and ``ssm`` (`models/ssm.py`) and caches an `SSMCache`;
a hybrid's attention layer holds ``norm1`` and ``norm2`` only, its
attention and MLP weights living once in ``params["shared_attn"]``, which
every such layer runs.  vlm and audio raise, as does the reference's
``long_context`` serving mode (ROADMAP.md Queue 1 item 16b).

The training path (`forward_hidden`, `chunked_ce`, `loss_fn`) runs no
cache, so its attention is the plain `attention._sdpa_chunked` and every
op is differentiable under `torch.func.vmap(grad(...))`; its f32 vocab
products upcast their inputs (the reference's ``preferred_element_type``
as an f32 GEMM), since ``torch.mm(..., out_dtype=)`` has neither a
batching rule nor a CPU kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.attention import (LATER, KVCache, attn_init,
                                          attention, init_cache)
from repro_torch.models.layers import (dense_apply, dense_init,
                                       embedding_init, embedding_lookup,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init, softcap, vmapped)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import (SSMCache, init_ssm_cache, ssm_apply,
                                    ssm_init)


def check_family(cfg: ModelConfig) -> None:
    """Raise for what this stack does not run yet (ROADMAP item 16b)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(f"the {cfg.family} family is {LATER}")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.pos_embedding} positions are {LATER}")


# ---------------------------------------------------------------------------
# init


def _shared_block(cfg: ModelConfig) -> bool:
    return cfg.family == "hybrid" and cfg.hybrid.shared_block


def _layer_init(gen: torch.Generator, cfg: ModelConfig, i: int,
                device: DeviceLike) -> Dict[str, Any]:
    p = {"norm1": norm_init(cfg.norm, cfg.d_model, cfg.pdtype, device)}
    if cfg.layer_kind(i) == "ssm":
        p["ssm"] = ssm_init(gen, cfg, device)
        return p
    p["norm2"] = norm_init(cfg.norm, cfg.d_model, cfg.pdtype, device)
    if _shared_block(cfg):
        return p            # attn / mlp weights live in params["shared_attn"]
    p["attn"] = attn_init(gen, cfg, device=device)
    if cfg.is_moe_layer(i):
        p["moe"] = moe_init(gen, cfg, device)
    else:                       # a MoE config's dense-first layers
        d_ff = cfg.moe.dense_d_ff if cfg.moe is not None else cfg.d_ff
        p["mlp"] = mlp_init(gen, cfg.d_model, d_ff, cfg.gated_mlp,
                            cfg.pdtype, device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random params in ``cfg.pdtype`` (an SSM layer's A_log, D and
    dt_bias in f32) from ``gen`` (a generator on ``device``): embedding,
    then each layer, then the untied head, then a hybrid's shared
    attention block."""
    check_family(cfg)
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype,
                                device),
        "layers": [_layer_init(gen, cfg, i, device)
                   for i in range(cfg.n_layers)],
        "final_norm": norm_init(cfg.norm, cfg.d_model, cfg.pdtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  cfg.pdtype, device=device)
    if _shared_block(cfg):
        p["shared_attn"] = {
            "attn": attn_init(gen, cfg, device=device),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                            cfg.pdtype, device)}
    return p


# ---------------------------------------------------------------------------
# caches and blocks


def make_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
                device: DeviceLike = "cuda") -> List[Union[KVCache, SSMCache]]:
    """One cache per layer: an attention layer's ring (an MLA layer's
    holds the compressed latent; a windowed layer's ring is min(cache_len,
    window) long), an SSM layer's `SSMCache` (conv carry and state)."""
    check_family(cfg)
    caches: List[Union[KVCache, SSMCache]] = []
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "ssm":
            caches.append(init_ssm_cache(cfg, batch, dtype, device))
            continue
        w = cfg.attn_window(i)
        clen = min(cache_len, w) if w is not None else cache_len
        caches.append(init_cache(cfg, batch, clen, dtype, device))
    return caches


def _block_apply(params, cfg: ModelConfig, i: int, x: torch.Tensor,
                 start: int, *, cache=None, shared=None, decode: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Any]:
    """Pre-norm residual block.  Returns (x, aux, cache): aux the MoE
    layer's load-balance loss, None on a dense or SSM layer (the
    reference's zero).  ``shared`` is a hybrid's shared attention block
    (``params["shared_attn"]``: its ``attn`` and ``mlp``), which an
    attention layer runs in place of its own; ``decode`` sends an SSM
    layer down its one-token state update."""
    cd = cfg.cdtype
    h = norm_apply(cfg.norm, params["norm1"], x, cd)
    if cfg.layer_kind(i) == "ssm":
        y, cache = ssm_apply(params["ssm"], cfg, h, cache, decode=decode)
        return x + y, None, cache
    blk = shared if shared is not None else params
    y, cache = attention(blk["attn"], cfg, h, start, cache=cache,
                         window=cfg.attn_window(i))
    x = x + y
    h = norm_apply(cfg.norm, params["norm2"], x, cd)
    if "moe" in params:
        y, aux = moe_apply(params["moe"], cfg, h)
        return x + y, aux, cache
    return x + mlp_apply(blk["mlp"], h, cfg.activation, cd), None, cache



def add_aux(total: torch.Tensor, aux: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """The running aux plus a block's (None adds the reference's 0)."""
    return total if aux is None else total + aux


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """Token embedding, times sqrt(d_model) rounded to the compute dtype
    where the config asks for it."""
    cd = cfg.cdtype
    x = embedding_lookup(params["embed"], batch["tokens"], cd)
    if cfg.emb_scale_by_sqrt_dim:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cd))
    return x


def _matmul_f32(x: torch.Tensor, w: torch.Tensor,
                train: bool = False) -> torch.Tensor:
    """x (.., d) @ w (d, V) with an f32 result from compute-dtype inputs
    (the reference's ``preferred_element_type=float32``); ``train``, or
    an ``x`` under vmap, upcasts the inputs (differentiable, vmappable:
    ``torch.mm(..., out_dtype=)`` has no batching rule)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda and not train and not vmapped(x):
        lead = x.shape[:-1]
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.to(x.dtype),
                       out_dtype=torch.float32)
        return out.reshape(*lead, w.shape[-1])
    return x.float() @ w.float()


def _unembed(params, cfg: ModelConfig, x: torch.Tensor,
             train: bool = False) -> torch.Tensor:
    cd = cfg.cdtype
    x = norm_apply(cfg.norm, params["final_norm"], x, cd)
    if cfg.tie_embeddings:
        logits = _matmul_f32(x, params["embed"].T, train)
    else:
        logits = dense_apply(params["lm_head"], x, torch.float32)
    return softcap(logits, cfg.final_logit_softcap)


# sequence-chunked cross entropy: the full (B, S, V) logits are never
# live at once
CE_CHUNK = 512


def chunked_ce(params, cfg: ModelConfig, hidden: torch.Tensor,
               targets: torch.Tensor, *, chunk: int = CE_CHUNK
               ) -> torch.Tensor:
    """Mean next-token CE.  hidden (B, S, d) before the final norm;
    targets (B, S), already shifted.  The sequence runs in chunks of
    ``chunk`` (the last padded, its padded positions masked), each
    chunk's vocab product and log-softmax in f32."""
    b, s = hidden.shape[:2]
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(hidden.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = _unembed(params, cfg, hidden[:, sl], train=True)
        lps = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(lps, -1, targets[:, sl, None].long())[..., 0]
        pos = c * chunk + torch.arange(chunk, device=hidden.device)
        nll = torch.where(pos[None, :] < s, nll, torch.zeros_like(nll))
        total = total + nll.sum()
    return total / (b * s)


# ---------------------------------------------------------------------------
# entry points


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack's forward (no cache) up to, not including, the final norm
    and unembed.  Returns (hidden, aux), aux the MoE layers' summed
    load-balance loss (a zero in the dense family)."""
    check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, aux, _ = _block_apply(lp, cfg, i, x, 0,
                                 shared=params.get("shared_attn"))
        aux_total = add_aux(aux_total, aux)
    return x, aux_total


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (no cache).  Returns (logits f32, aux)."""
    x, aux = forward_hidden(params, cfg, batch)
    return _unembed(params, cfg, x), aux


def _ce_from_hidden(params, cfg: ModelConfig, hidden: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE over the text positions of ``hidden``."""
    n_text = tokens.shape[1]
    h = hidden[:, -n_text:][:, :-1]
    return chunked_ce(params, cfg, h, tokens[:, 1:])


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ aux).  Returns (loss, {"ce", "aux",
    "loss"})."""
    hidden, aux = forward_hidden(params, cfg, batch)
    ce = _ce_from_hidden(params, cfg, hidden, batch["tokens"])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            caches: List[Union[KVCache, SSMCache]]):
    """Run a prompt from position 0, filling the caches (the rings in
    place, an SSM layer's cache replaced in the list).  Returns
    (last-position logits (B, 1, V) f32, caches)."""
    check_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    for i, lp in enumerate(params["layers"]):
        x, _, caches[i] = _block_apply(lp, cfg, i, x, 0, cache=caches[i],
                                       shared=params.get("shared_attn"))
    return _unembed(params, cfg, x[:, -1:]), caches


def lockstep_position(pos: Union[int, torch.Tensor]) -> int:
    """The one position of a lockstep batch: ``pos`` as an int, or a (B,)
    tensor whose entries must all be equal (one host read)."""
    if isinstance(pos, torch.Tensor):
        vals = pos.reshape(-1).tolist()
        if len(set(vals)) != 1:
            raise ValueError(f"positions {vals} are not in lockstep")
        return int(vals[0])
    return int(pos)


def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                caches: List[Union[KVCache, SSMCache]],
                pos: Union[int, torch.Tensor]):
    """One decode step.  token (B, 1); pos the lockstep position (an int,
    or a (B,) tensor of equal entries).  Returns (logits (B, 1, V) f32,
    caches)."""
    check_family(cfg)
    p = lockstep_position(pos)
    x = _embed_inputs(params, cfg, {"tokens": token})
    for i, lp in enumerate(params["layers"]):
        x, _, caches[i] = _block_apply(lp, cfg, i, x, p, cache=caches[i],
                                       shared=params.get("shared_attn"),
                                       decode=True)
    return _unembed(params, cfg, x), caches
