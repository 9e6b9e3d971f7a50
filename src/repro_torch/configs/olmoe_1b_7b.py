"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060].  Counterpart of
`repro/configs/olmoe_1b_7b.py`."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    d_ff=1024,                  # per-expert FFN width
    vocab_size=50304,
    attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                         rope_theta=10000.0, qk_norm=True),
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024,
                  router_aux_coef=0.01),
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=False,
    max_seq_len=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="arXiv:2409.02060 (OLMoE: Open Mixture-of-Experts Language Models)",
)
