"""Whisper-style encoder-decoder: init, encoder, decoder, loss and serving.

Counterpart of `repro/models/encdec.py`, function by function.  The
conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_ctx, d_model) (``batch
["audio_embeds"]``).  The encoder adds f32 sinusoidal positions cast to
the compute dtype and runs bidirectional self-attention; the decoder adds
learned positions (clipped to ``max_seq_len − 1``) and runs causal
self-attention over its ring, then cross-attention over the encoder's
output, with no RoPE.  Params are the reference's unscanned dict:
``embed``, ``pos_emb``, ``enc_layers`` (``norm1``/``attn``/``norm2``/
``mlp``), ``enc_final_norm``, ``layers`` (``norm1``/``attn``/``norm_x``/
``cross``/``norm2``/``mlp``) and ``final_norm``; the head is tied.

Training (`encdec_loss_fn`, `decode_hidden`) runs the plain
differentiable attention (`attention._sdpa_chunked`, kinds ``"full"``
and ``"causal"``).  Serving (`encdec_prefill`, `encdec_decode_step`)
runs every attention product through `kernels.ops.flash_attention`: the
encoder's self-attention (non-causal, Sq = Sk = n_ctx), the decoder's
self-attention over its ring, and the cross-attention, non-causal over
the n_ctx encoder positions.  The cross K/V are computed once at
prefill and kept in each layer's cache dict (``self``, ``cross_k``,
``cross_v``), as the reference keeps them.  A prefill is thus
``enc_layers + 2·n_layers`` flash launches, a decode step
``2·n_layers``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.attention import attention, attn_init, init_cache
from repro_torch.models.layers import (dense_apply, embedding_init,
                                       embedding_lookup, mlp_apply,
                                       mlp_init, norm_apply, norm_init,
                                       sinusoidal_positions)
from repro_torch.models.transformer import (_ce_from_hidden, _unembed,
                                            lockstep_position)


def encdec_init(gen: torch.Generator, cfg: ModelConfig,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random params in ``cfg.pdtype`` from ``gen`` (a generator on
    ``device``), drawn in the reference's order: the token embedding,
    the position embedding, each encoder layer (attention, MLP), each
    decoder layer (self-attention, cross-attention, MLP)."""
    d, dt = cfg.d_model, cfg.pdtype

    def norm():
        return norm_init(cfg.norm, d, dt, device)

    def mlp():
        return mlp_init(gen, d, cfg.d_ff, cfg.gated_mlp, dt, device)

    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, d, dt, device),
        "pos_emb": embedding_init(gen, cfg.max_seq_len, d, dt, device)}
    p["enc_layers"] = []
    for _ in range(cfg.encoder.n_layers):
        lp = {"norm1": norm(), "attn": attn_init(gen, cfg, device=device)}
        p["enc_layers"].append(dict(lp, norm2=norm(), mlp=mlp()))
    p["enc_final_norm"] = norm()
    p["layers"] = []
    for _ in range(cfg.n_layers):
        lp = {"norm1": norm(), "attn": attn_init(gen, cfg, device=device),
              "norm_x": norm()}
        lp["cross"] = attn_init(gen, cfg, cross=True, device=device)
        p["layers"].append(dict(lp, norm2=norm(), mlp=mlp()))
    p["final_norm"] = norm()
    return p


def encode(params, cfg: ModelConfig, audio_embeds: torch.Tensor, *,
           flash: bool = False) -> torch.Tensor:
    """The encoder over audio_embeds (B, n_ctx, d), the stub frontend's
    output.  ``flash``: the self-attention through the flash op (the
    serving path), else the plain differentiable path."""
    cd = cfg.cdtype
    x = audio_embeds.to(cd)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(cd)[None]
    for lp in params["enc_layers"]:
        h = norm_apply(cfg.norm, lp["norm1"], x, cd)
        y, _ = attention(lp["attn"], cfg, h, 0, mask_kind="full",
                         flash=flash)
        x = x + y
        h = norm_apply(cfg.norm, lp["norm2"], x, cd)
        x = x + mlp_apply(lp["mlp"], h, cfg.activation, cd)
    return norm_apply(cfg.norm, params["enc_final_norm"], x, cd)


def _dec_block(lp, cfg: ModelConfig, x: torch.Tensor, enc_out: torch.Tensor
               ) -> torch.Tensor:
    """A decoder block of the training path (no cache, positions from 0):
    causal self-attention, cross-attention over ``enc_out``, the MLP."""
    cd = cfg.cdtype
    h = norm_apply(cfg.norm, lp["norm1"], x, cd)
    y, _ = attention(lp["attn"], cfg, h, 0)
    x = x + y
    h = norm_apply(cfg.norm, lp["norm_x"], x, cd)
    y, _ = attention(lp["cross"], cfg, h, 0, kv_input=enc_out)
    x = x + y
    h = norm_apply(cfg.norm, lp["norm2"], x, cd)
    return x + mlp_apply(lp["mlp"], h, cfg.activation, cd)


def _dec_embed(params, cfg: ModelConfig, tokens: torch.Tensor,
               start: int) -> torch.Tensor:
    """Token embedding plus the learned position embedding of positions
    start..start+S−1, clipped to ``max_seq_len − 1``."""
    cd = cfg.cdtype
    pos = torch.arange(start, start + tokens.shape[1],
                       device=tokens.device).clamp(0, cfg.max_seq_len - 1)
    return embedding_lookup(params["embed"], tokens, cd) + \
        params["pos_emb"][pos].to(cd)


def decode_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder over tokens (B, S) from position 0, up to (not
    including) the final norm."""
    x = _dec_embed(params, cfg, tokens, 0)
    for lp in params["layers"]:
        x = _dec_block(lp, cfg, x, enc_out)
    return x


def decode(params, cfg: ModelConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder's logits (B, S, V) f32."""
    return _unembed(params, cfg, decode_hidden(params, cfg, tokens,
                                               enc_out))


def encdec_loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token CE of the decoder over ``batch["tokens"]`` given
    ``batch["audio_embeds"]`` (a batch without them raises `KeyError`, as
    the reference's does).  Returns (loss, {"ce", "aux", "loss"})."""
    enc_out = encode(params, cfg, batch["audio_embeds"])
    hidden = decode_hidden(params, cfg, batch["tokens"], enc_out)
    ce = _ce_from_hidden(params, cfg, hidden, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"ce": ce, "aux": aux, "loss": ce}


# ---------------------------------------------------------------------------
# serving: the cross K/V computed at prefill and kept


def encdec_make_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                       device: DeviceLike = "cuda") -> List[Dict[str, Any]]:
    """Per decoder layer: ``self``, the self-attention's ring, and
    ``cross_k``/``cross_v`` (B, n_ctx, Kh, hd), zeros until a prefill
    replaces them."""
    a, dev = cfg.attn, resolve_device(device)
    shape = (batch, cfg.encoder.n_ctx, a.n_kv_heads, a.head_dim)
    return [{"self": init_cache(cfg, batch, cache_len, dtype, dev),
             "cross_k": torch.zeros(shape, dtype=dtype, device=dev),
             "cross_v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _cross_kv(lp, cfg: ModelConfig, enc_out: torch.Tensor):
    cd = cfg.cdtype
    return (dense_apply(lp["cross"]["wk"], enc_out, cd),
            dense_apply(lp["cross"]["wv"], enc_out, cd))


def _cross_attend(lp, cfg: ModelConfig, h: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor) -> torch.Tensor:
    """h's queries over the kept cross K/V (B, n_ctx, Kh, hd): one
    non-causal flash call."""
    cd = cfg.cdtype
    b, s = h.shape[:2]
    q = dense_apply(lp["cross"]["wq"], h, cd)
    out = ops.flash_attention(q.transpose(1, 2), ck.transpose(1, 2).to(cd),
                              cv.transpose(1, 2).to(cd), causal=False,
                              softcap=cfg.attn.attn_logit_softcap)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return dense_apply(lp["cross"]["wo"], out, cd)


def _serve_block(lp, cfg: ModelConfig, x: torch.Tensor, start: int,
                 cache: Dict[str, Any], window) -> torch.Tensor:
    """A served decoder block: self-attention over the ring (updated in
    place), cross-attention over the kept K/V, the MLP."""
    cd = cfg.cdtype
    h = norm_apply(cfg.norm, lp["norm1"], x, cd)
    y, cache["self"] = attention(lp["attn"], cfg, h, start,
                                 cache=cache["self"], window=window)
    x = x + y
    h = norm_apply(cfg.norm, lp["norm_x"], x, cd)
    x = x + _cross_attend(lp, cfg, h, cache["cross_k"], cache["cross_v"])
    h = norm_apply(cfg.norm, lp["norm2"], x, cd)
    return x + mlp_apply(lp["mlp"], h, cfg.activation, cd)


def encdec_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   caches: List[Dict[str, Any]], *,
                   long_context: bool = False):
    """Encode ``batch["audio_embeds"]``, keep each layer's cross K/V and
    run the prompt ``batch["tokens"]`` (B, P) through the decoder from
    position 0.  ``long_context`` windows the self-attention at
    ``long_context_window``.  Returns (last-position logits (B, 1, V)
    f32, caches)."""
    enc_out = encode(params, cfg, batch["audio_embeds"], flash=True)
    x = _dec_embed(params, cfg, batch["tokens"], 0)
    window = cfg.attn.long_context_window if long_context else None
    for lp, c in zip(params["layers"], caches):
        c["cross_k"], c["cross_v"] = _cross_kv(lp, cfg, enc_out)
        x = _serve_block(lp, cfg, x, 0, c, window)
    return _unembed(params, cfg, x[:, -1:]), caches


def encdec_decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                       caches: List[Dict[str, Any]],
                       pos: Union[int, torch.Tensor], *,
                       long_context: bool = False):
    """One decode step of token (B, 1) at the lockstep position ``pos``.
    Returns (logits (B, 1, V) f32, caches)."""
    p = lockstep_position(pos)
    x = _dec_embed(params, cfg, token, p)
    window = cfg.attn.long_context_window if long_context else None
    for lp, c in zip(params["layers"], caches):
        x = _serve_block(lp, cfg, x, p, c, window)
    return _unembed(params, cfg, x), caches
