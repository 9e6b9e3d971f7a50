"""Gemma-2B — GeGLU, head_dim=256, MQA [arXiv:2403.08295].  Counterpart
of `repro/configs/gemma_2b.py`."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=256000,
    attn=AttentionConfig(n_heads=8, n_kv_heads=1, head_dim=256,
                         rope_theta=10000.0),
    activation="geglu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
    max_seq_len=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="arXiv:2403.08295 (Gemma: Open Models Based on Gemini)",
)
