"""Configuration schema of the LM path.

Counterpart of `repro/configs/base.py`: a copy of its dataclasses (plain
data, the same fields and defaults) and of `reduced`, with `pdtype` and
`cdtype` returning torch dtypes, and of `param_count` and
`active_param_count`, the analytic counts behind the planner's model
FLOPs (`roofline/analysis.py`).  The port runs the dense, MoE, SSM and
hybrid families (`models/transformer.py`, MLA attention included,
`models/ssm.py`); the audio and vision blocks are kept so that a config
reads the same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0          # stablelm uses partial rotary
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    window: Optional[int] = None        # window of "local" layers
    layer_pattern: Tuple[str, ...] = ("global",)   # cycled over layers
    mla: Optional[MLAConfig] = None
    qk_norm: bool = False
    long_context_window: int = 8192
    mla_absorb: bool = False
    seq_parallel: bool = False


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    group_size: int = 1024


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_ctx: int = 1500
    frontend: str = "stub"


@dataclass(frozen=True)
class VisionConfig:
    n_tokens: int = 256
    embed_dim: int = 1152
    frontend: str = "stub"


@dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6
    shared_block: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    hybrid: Optional[HybridConfig] = None
    activation: str = "silu"    # silu|geglu|gelu|relu2
    gated_mlp: bool = True
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = True
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    emb_scale_by_sqrt_dim: bool = False          # gemma family
    max_seq_len: int = 8192
    pos_embedding: str = "rope"  # rope | learned | sinusoidal | none
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    fl_client_axis: str = "data"
    serve_tp: bool = False
    source: str = ""

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def layer_kind(self, i: int) -> str:
        """Block kind at layer i: 'attn' | 'ssm' (hybrid interleave)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            every = self.hybrid.attn_every
            return "attn" if (i % every) == (every - 1) else "ssm"
        return "attn"

    def attn_window(self, i: int) -> Optional[int]:
        """Sliding window for attention layer i (None = full)."""
        if self.attn is None:
            return None
        pat = self.attn.layer_pattern
        kind = pat[i % len(pat)]
        return self.attn.window if kind == "local" else None

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and i >= self.moe.n_dense_layers

    def with_dtypes(self, param_dtype: str, compute_dtype: str
                    ) -> "ModelConfig":
        return replace(self, param_dtype=param_dtype,
                       compute_dtype=compute_dtype)


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512, max_seq: int = 256) -> ModelConfig:
    """The smoke variant of the same family: <= 2 layers, d_model <= 512,
    f32, every width shrunk as `repro.configs.base.reduced` does."""
    d_model = min(d_model, 512)
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, n_layers),
        d_model=d_model,
        d_ff=min(cfg.d_ff, 4 * d_model) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, vocab),
        max_seq_len=min(cfg.max_seq_len, max_seq),
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.attn is not None:
        n_heads = min(cfg.attn.n_heads, 4)
        n_kv = max(1, min(cfg.attn.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        mla = None
        if cfg.attn.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16)
        head_dim = d_model // n_heads if mla is None else cfg.attn.head_dim
        updates["attn"] = replace(
            cfg.attn, n_heads=n_heads, n_kv_heads=n_kv,
            head_dim=head_dim, mla=mla,
            window=None if cfg.attn.window is None else 64,
            long_context_window=64)
    if cfg.moe is not None:
        updates["moe"] = replace(
            cfg.moe, n_experts=4, top_k=2, d_expert=2 * d_model,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            n_dense_layers=min(cfg.moe.n_dense_layers, 1),
            dense_d_ff=min(cfg.moe.dense_d_ff, 4 * d_model),
            group_size=64)
    if cfg.ssm is not None:
        updates["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16,
                                 chunk_size=32)
    if cfg.encoder is not None:
        updates["encoder"] = replace(
            cfg.encoder, n_layers=min(cfg.encoder.n_layers, 2), n_ctx=32)
    if cfg.vision is not None:
        updates["vision"] = replace(cfg.vision, n_tokens=8, embed_dim=64)
    if cfg.hybrid is not None:
        updates["hybrid"] = replace(cfg.hybrid, attn_every=2)
    return replace(cfg, **updates)




def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (the planner's model FLOPs)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    total = V * d  # embedding
    if not cfg.tie_embeddings:
        total += V * d
    for i in range(L):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            total += _attn_params(cfg)
            total += _ffn_params(cfg, i)
        else:
            total += _ssm_params(cfg)
        total += 2 * d  # two norms
    if cfg.family == "hybrid" and cfg.hybrid and cfg.hybrid.shared_block:
        # shared attention block counted once (above loop counted per use; fix)
        n_attn = sum(1 for i in range(L) if cfg.layer_kind(i) == "attn")
        if n_attn > 1:
            total -= (n_attn - 1) * (_attn_params(cfg) + _ffn_params(cfg, 0))
    if cfg.encoder is not None:
        enc = cfg.encoder.n_layers * (_attn_params(cfg) + _ffn_params(cfg, 0) + 4 * d)
        # cross attention in each decoder layer
        enc += L * _attn_params(cfg)
        total += enc
    if cfg.vision is not None:
        total += cfg.vision.embed_dim * d  # projector
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top_k + shared experts count)."""
    if cfg.moe is None:
        return param_count(cfg)
    total = param_count(cfg)
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    n_moe_layers = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
    inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
    return total - inactive


def _attn_params(cfg: ModelConfig) -> int:
    a = cfg.attn
    d = cfg.d_model
    if a is None:
        return 0
    if a.mla is not None:
        mm = a.mla
        qk_dim = mm.qk_nope_head_dim + mm.qk_rope_head_dim
        n = d * mm.q_lora_rank + mm.q_lora_rank * a.n_heads * qk_dim
        n += d * (mm.kv_lora_rank + mm.qk_rope_head_dim)
        n += mm.kv_lora_rank * a.n_heads * (mm.qk_nope_head_dim + mm.v_head_dim)
        n += a.n_heads * mm.v_head_dim * d
        return n
    q = d * a.n_heads * a.head_dim
    kv = 2 * d * a.n_kv_heads * a.head_dim
    o = a.n_heads * a.head_dim * d
    return q + kv + o


def _ffn_params(cfg: ModelConfig, i: int) -> int:
    d = cfg.d_model
    if cfg.moe is not None and cfg.is_moe_layer(i):
        m = cfg.moe
        n = m.n_experts * 3 * d * m.d_expert
        n += m.n_shared_experts * 3 * d * m.d_expert
        n += d * m.n_experts  # router
        return n
    if cfg.moe is not None:
        return 3 * d * cfg.moe.dense_d_ff
    mult = 3 if cfg.gated_mlp else 2
    return mult * d * cfg.d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    if s is None:
        return 0
    d_in = s.expand * d
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    n = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
    n += conv_dim * s.d_conv                                    # conv1d
    n += 2 * n_heads                                            # A_log, D
    n += n_heads                                                # dt_bias
    n += d_in * d                                               # out_proj
    n += d_in                                                   # gated norm
    return n
