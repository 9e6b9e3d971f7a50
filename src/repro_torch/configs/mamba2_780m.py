"""Mamba2-780M — attention-free SSD (state-space duality)
[arXiv:2405.21060].  Counterpart of `repro/configs/mamba2_780m.py`, field
for field: 48 SSD blocks (`models/ssm.py`), no attention and no MLP."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    d_ff=0,                      # attention-free, no MLP blocks
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    activation="silu",
    norm="rmsnorm",
    tie_embeddings=True,
    max_seq_len=8192,
    pos_embedding="none",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="arXiv:2405.21060 (Transformers are SSMs: Mamba-2 / SSD)",
)
