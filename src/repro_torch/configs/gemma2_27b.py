"""Gemma2-27B — local/global alternating attention, logit softcaps
[arXiv:2408.00118].  Counterpart of `repro/configs/gemma2_27b.py`."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab_size=256000,
    attn=AttentionConfig(n_heads=32, n_kv_heads=16, head_dim=128,
                         rope_theta=10000.0,
                         attn_logit_softcap=50.0,
                         window=4096,
                         layer_pattern=("local", "global")),
    activation="geglu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=True,
    emb_scale_by_sqrt_dim=True,
    final_logit_softcap=30.0,
    max_seq_len=8192,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="arXiv:2408.00118 (Gemma 2: Improving Open LMs at Practical Size)",
)
