"""PaliGemma-3B — a SigLIP vision frontend (a stub: the batch carries the
patch embeddings) and the Gemma-2B language backbone [arXiv:2407.07726].
Counterpart of `repro/configs/paligemma_3b.py`."""
from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                      VisionConfig)

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257216,
    attn=AttentionConfig(n_heads=8, n_kv_heads=1, head_dim=256,
                         rope_theta=10000.0),
    vision=VisionConfig(n_tokens=256, embed_dim=1152, frontend="stub"),
    activation="geglu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
    max_seq_len=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="arXiv:2407.07726 (PaliGemma: A versatile 3B VLM)",
)
