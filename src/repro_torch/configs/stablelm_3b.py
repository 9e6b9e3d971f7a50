"""StableLM-3B — dense decoder, partial rotary
[hf:stabilityai/stablelm-2-1_6b].  Counterpart of
`repro/configs/stablelm_3b.py`."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    d_ff=6912,
    vocab_size=50304,
    attn=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=80,
                         rope_theta=10000.0, rope_fraction=0.25),
    activation="silu",
    gated_mlp=True,
    norm="layernorm",
    tie_embeddings=False,
    max_seq_len=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="hf:stabilityai/stablelm-2-1_6b (family scaled per assignment)",
)
