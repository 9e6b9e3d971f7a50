"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  Counterpart of `repro/configs/zamba2_2p7b.py`, field
for field: every 6th of the 54 layers runs one attention + MLP block
whose weights all those layers share (``params["shared_attn"]``)."""
from repro_torch.configs.base import (AttentionConfig, HybridConfig,
                                      ModelConfig, SSMConfig)

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10240,                  # shared attention block MLP width
    vocab_size=32000,
    attn=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=80,
                         rope_theta=10000.0),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_block=True),
    activation="geglu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=True,
    max_seq_len=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="arXiv:2411.15242 (Zamba2 suite: hybrid Mamba2+shared-attention)",
)
