"""Dense decoder stack: init, caches, forward, prefill and decode.

Counterpart of `repro/models/transformer.py` for the dense family, in its
loop form (the reference's `models/scan.py` is numerically the loop's;
`convert.lm_params_from_numpy` unstacks its params):

    params          = init_params(gen, cfg, device=...)
    logits, aux     = forward(params, cfg, batch)
    loss, metrics   = loss_fn(params, cfg, batch)
    caches          = make_caches(cfg, batch, cache_len, dtype, device=...)
    logits, caches  = prefill(params, cfg, batch, caches)
    logits, caches  = decode_step(params, cfg, token, caches, pos)

Params are the reference's dict: ``embed`` (V, d), ``layers`` (a list of
``norm1``/``attn``/``norm2``/``mlp`` dicts), ``final_norm`` and, untied,
``lm_head`` (d, V).  MoE, SSM, hybrid, vlm and audio raise, as does the
reference's ``long_context`` serving mode (ROADMAP.md Queue 1 item 16b).

The training path (`forward_hidden`, `chunked_ce`, `loss_fn`) runs no
cache, so its attention is the plain `attention._sdpa_chunked` and every
op is differentiable under `torch.func.vmap(grad(...))`; its f32 vocab
products upcast their inputs (the reference's ``preferred_element_type``
as an f32 GEMM), since ``torch.mm(..., out_dtype=)`` has neither a
batching rule nor a CPU kernel.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.attention import (LATER, KVCache, attn_init,
                                          attention, init_cache)
from repro_torch.models.layers import (dense_apply, dense_init,
                                       embedding_init, embedding_lookup,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init, softcap)


def _dense_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(f"the {cfg.family} family is {LATER}")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.pos_embedding} positions are {LATER}")


# ---------------------------------------------------------------------------
# init


def _layer_init(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike) -> Dict[str, Any]:
    return {
        "norm1": norm_init(cfg.norm, cfg.d_model, cfg.pdtype, device),
        "norm2": norm_init(cfg.norm, cfg.d_model, cfg.pdtype, device),
        "attn": attn_init(gen, cfg, device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                        cfg.pdtype, device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random params in ``cfg.pdtype`` from ``gen`` (a generator on
    ``device``): embedding, then each layer, then the untied head."""
    _dense_family(cfg)
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype,
                                device),
        "layers": [_layer_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": norm_init(cfg.norm, cfg.d_model, cfg.pdtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  cfg.pdtype, device=device)
    return p


# ---------------------------------------------------------------------------
# caches and blocks


def make_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
                device: DeviceLike = "cuda") -> List[KVCache]:
    """One ring per layer; a windowed layer's ring is min(cache_len,
    window) long."""
    _dense_family(cfg)
    caches = []
    for i in range(cfg.n_layers):
        w = cfg.attn_window(i)
        clen = min(cache_len, w) if w is not None else cache_len
        caches.append(init_cache(cfg, batch, clen, dtype, device))
    return caches


def _block_apply(params, cfg: ModelConfig, i: int, x: torch.Tensor,
                 start: int, *, cache=None) -> Tuple[torch.Tensor, Any]:
    """Pre-norm residual block.  Returns (x, cache); the reference's MoE
    aux loss has no dense counterpart."""
    cd = cfg.cdtype
    h = norm_apply(cfg.norm, params["norm1"], x, cd)
    y, cache = attention(params["attn"], cfg, h, start, cache=cache,
                         window=cfg.attn_window(i))
    x = x + y
    h = norm_apply(cfg.norm, params["norm2"], x, cd)
    return x + mlp_apply(params["mlp"], h, cfg.activation, cd), cache


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
    (the reference's ``preferred_element_type=float32``); ``train``
    upcasts the inputs (differentiable, vmappable)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.is_cuda and not train:
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
    and unembed.  Returns (hidden, aux), aux a zero (the dense family has
    no auxiliary loss)."""
    _dense_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    for i, lp in enumerate(params["layers"]):
        x, _ = _block_apply(lp, cfg, i, x, 0)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


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
            caches: List[KVCache]):
    """Run a prompt from position 0, filling the caches in place.  Returns
    (last-position logits (B, 1, V) f32, caches)."""
    _dense_family(cfg)
    x = _embed_inputs(params, cfg, batch)
    for i, lp in enumerate(params["layers"]):
        x, caches[i] = _block_apply(lp, cfg, i, x, 0, cache=caches[i])
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
                caches: List[KVCache], pos: Union[int, torch.Tensor]):
    """One decode step.  token (B, 1); pos the lockstep position (an int,
    or a (B,) tensor of equal entries).  Returns (logits (B, 1, V) f32,
    caches)."""
    _dense_family(cfg)
    p = lockstep_position(pos)
    x = _embed_inputs(params, cfg, {"tokens": token})
    for i, lp in enumerate(params["layers"]):
        x, caches[i] = _block_apply(lp, cfg, i, x, p, cache=caches[i])
    return _unembed(params, cfg, x), caches
