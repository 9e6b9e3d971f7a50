"""Decoder stack of the dense, MoE, SSM, hybrid and vlm families: init,
caches, forward, prefill and decode; the audio family (whisper's
encoder-decoder) dispatches to `models/encdec.py`.

Counterpart of `repro/models/transformer.py`, in its loop form (the
reference's `models/scan.py` is numerically the loop's;
`convert.lm_params_from_numpy` unstacks its params):

    params          = init_params(gen, cfg, device=...)
    logits, aux     = forward(params, cfg, batch)
    loss, metrics   = loss_fn(params, cfg, batch)
    caches          = make_caches(cfg, batch, cache_len, dtype, device=...,
                                  long_context=False)
    logits, caches  = prefill(params, cfg, batch, caches, long_context=...)
    logits, caches  = decode_step(params, cfg, token, caches, pos,
                                  long_context=...)

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
every such layer runs.  A vlm config (paligemma-3b) adds ``vision_proj``
(embed_dim, d): a batch's ``vision_embeds`` (B, n_vision, embed_dim) are
projected in the compute dtype (not scaled by √d) and put before the
scaled text embedding, and that prefix is bidirectional under the
causal mask (``prefix_len``, in the flash op's kernels too); the text
positions follow it, so a decode step after a P-token prompt with an
image runs at position n_vision + P.  A learned-positions config adds
``pos_emb`` (max_seq_len, d).

``long_context`` is the reference's long_500k serving mode: every
attention layer's window is narrowed to ``attn.long_context_window``
(a global layer's from none), and `make_caches` bounds its ring to it,
so decode runs over rings that wrap.  For the audio family, as in the
reference, only the ring length follows it: `prefill` and `decode_step`
do not pass it on to `encdec.py`.

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
from repro_torch.models.attention import (KVCache, attn_init, attention,
                                          init_cache)
from repro_torch.models.layers import (dense_apply, dense_init,
                                       embedding_init, embedding_lookup,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init, softcap, vmapped)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import (SSMCache, init_ssm_cache, ssm_apply,
                                    ssm_init)


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family or position scheme no reference config has."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{FAMILIES}")
    if cfg.pos_embedding not in ("rope", "none", "learned"):
        raise ValueError(f"unknown pos_embedding {cfg.pos_embedding!r}")


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
    then each layer, then the untied head, a hybrid's shared attention
    block, a vlm's ``vision_proj`` and learned positions' ``pos_emb``.
    The audio family: `encdec.encdec_init`."""
    check_family(cfg)
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_init
        return encdec_init(gen, cfg, device)
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
    if cfg.family == "vlm":
        p["vision_proj"] = dense_init(gen, cfg.vision.embed_dim,
                                      cfg.d_model, cfg.pdtype, device=device)
    if cfg.pos_embedding == "learned":
        p["pos_emb"] = embedding_init(gen, cfg.max_seq_len, cfg.d_model,
                                      cfg.pdtype, device)
    return p


# ---------------------------------------------------------------------------
# caches and blocks


def _window(cfg: ModelConfig, i: int, long_context: bool) -> Optional[int]:
    """Layer i's attention window, narrowed to ``long_context_window``
    under ``long_context``."""
    w = cfg.attn_window(i)
    if long_context:
        lc = cfg.attn.long_context_window
        w = min(w, lc) if w else lc
    return w


def make_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
                long_context: bool = False, device: DeviceLike = "cuda"
                ) -> List[Any]:
    """One cache per layer: an attention layer's ring (an MLA layer's
    holds the compressed latent; a windowed layer's ring is min(cache_len,
    window) long, every layer's under ``long_context``), an SSM layer's
    `SSMCache` (conv carry and state); the audio family's
    `encdec.encdec_make_caches`, its rings min(cache_len,
    long_context_window) long under ``long_context``."""
    check_family(cfg)
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_make_caches
        w = cfg.attn.long_context_window if long_context else cache_len
        return encdec_make_caches(cfg, batch, min(cache_len, w), dtype,
                                  device)
    caches: List[Union[KVCache, SSMCache]] = []
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "ssm":
            caches.append(init_ssm_cache(cfg, batch, dtype, device))
            continue
        w = _window(cfg, i, long_context)
        clen = min(cache_len, w) if w is not None else cache_len
        caches.append(init_cache(cfg, batch, clen, dtype, device))
    return caches


def _block_apply(params, cfg: ModelConfig, i: int, x: torch.Tensor,
                 start: int, *, cache=None, shared=None, decode: bool = False,
                 prefix_len: int = 0, long_context: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Any]:
    """Pre-norm residual block.  Returns (x, aux, cache): aux the MoE
    layer's load-balance loss, None on a dense or SSM layer (the
    reference's zero).  ``shared`` is a hybrid's shared attention block
    (``params["shared_attn"]``: its ``attn`` and ``mlp``), which an
    attention layer runs in place of its own; ``decode`` sends an SSM
    layer down its one-token state update; ``prefix_len`` and
    ``long_context`` as in the module docstring."""
    cd = cfg.cdtype
    h = norm_apply(cfg.norm, params["norm1"], x, cd)
    if cfg.layer_kind(i) == "ssm":
        y, cache = ssm_apply(params["ssm"], cfg, h, cache, decode=decode)
        return x + y, None, cache
    blk = shared if shared is not None else params
    y, cache = attention(blk["attn"], cfg, h, start, cache=cache,
                         window=_window(cfg, i, long_context),
                         prefix_len=prefix_len)
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


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  start: int = 0) -> Tuple[torch.Tensor, int]:
    """Token embedding, times sqrt(d_model) rounded to the compute dtype
    where the config asks for it; a vlm batch's ``vision_embeds``
    projected (not scaled) and put before it; learned positions from
    ``start``.  Returns (x, prefix_len), prefix_len the vision tokens'
    count (0 without them)."""
    cd = cfg.cdtype
    x = embedding_lookup(params["embed"], batch["tokens"], cd)
    if cfg.emb_scale_by_sqrt_dim:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cd))
    prefix_len = 0
    if cfg.family == "vlm" and "vision_embeds" in batch:
        v = dense_apply(params["vision_proj"],
                        batch["vision_embeds"].to(cd), cd)
        x = torch.cat([v, x], dim=1)
        prefix_len = v.shape[1]
    if cfg.pos_embedding == "learned":
        pos = torch.arange(start, start + x.shape[1], device=x.device)
        x = x + params["pos_emb"][pos].to(cd)
    return x, prefix_len


def _matmul_f32(x: torch.Tensor, w: torch.Tensor,
                train: bool = False) -> torch.Tensor:
    """x (.., d) @ w (d, V) with an f32 result from compute-dtype inputs
    (the reference's ``preferred_element_type=float32``); ``train``, or
    an ``x`` under vmap, upcasts the inputs (differentiable, vmappable:
    ``torch.mm(..., out_dtype=)`` has no batching rule); a ``meta`` x (the
    planner's) takes the card's branch."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.device.type in ("cuda", "meta") and not train and not vmapped(x):
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
    x, prefix_len = _embed_inputs(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, aux, _ = _block_apply(lp, cfg, i, x, 0,
                                 shared=params.get("shared_attn"),
                                 prefix_len=prefix_len)
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
    """Next-token cross-entropy (+ aux) over the text tokens.  Returns
    (loss, {"ce", "aux", "loss"}); the audio family's is
    `encdec.encdec_loss_fn`."""
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_loss_fn
        return encdec_loss_fn(params, cfg, batch)
    hidden, aux = forward_hidden(params, cfg, batch)
    ce = _ce_from_hidden(params, cfg, hidden, batch["tokens"])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            caches: List[Any], *, long_context: bool = False):
    """Run a prompt from position 0 (a vlm batch's image prefix first),
    filling the caches (the rings in place, an SSM layer's cache replaced
    in the list).  Returns (last-position logits (B, 1, V) f32,
    caches)."""
    check_family(cfg)
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_prefill
        return encdec_prefill(params, cfg, batch, caches)
    x, prefix_len = _embed_inputs(params, cfg, batch)
    for i, lp in enumerate(params["layers"]):
        x, _, caches[i] = _block_apply(lp, cfg, i, x, 0, cache=caches[i],
                                       shared=params.get("shared_attn"),
                                       prefix_len=prefix_len,
                                       long_context=long_context)
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
                caches: List[Any], pos: Union[int, torch.Tensor], *,
                long_context: bool = False):
    """One decode step.  token (B, 1); pos the lockstep position (an int,
    or a (B,) tensor of equal entries).  Returns (logits (B, 1, V) f32,
    caches)."""
    check_family(cfg)
    if cfg.family == "audio":
        from repro_torch.models.encdec import encdec_decode_step
        return encdec_decode_step(params, cfg, token, caches, pos)
    p = lockstep_position(pos)
    x, _ = _embed_inputs(params, cfg, {"tokens": token}, p)
    for i, lp in enumerate(params["layers"]):
        x, _, caches[i] = _block_apply(lp, cfg, i, x, p, cache=caches[i],
                                       shared=params.get("shared_attn"),
                                       decode=True,
                                       long_context=long_context)
    return _unembed(params, cfg, x), caches
