"""Nemotron-4-340B — GQA (8 kv heads), squared-ReLU MLP [arXiv:2402.16819].
Counterpart of `repro/configs/nemotron_4_340b.py`, field for field.  The
FL client axis is "pod": per-client copies do not fit one pod (the
reference's DESIGN.md §3)."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    d_ff=73728,
    vocab_size=256000,
    attn=AttentionConfig(n_heads=96, n_kv_heads=8, head_dim=192,
                         rope_theta=10000.0),
    activation="relu2",          # squared ReLU, non-gated
    gated_mlp=False,
    norm="layernorm",
    tie_embeddings=False,
    max_seq_len=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="pod",
    source="arXiv:2402.16819 (Nemotron-4 340B Technical Report)",
)
