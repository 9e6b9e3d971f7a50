"""Whisper-tiny — encoder-decoder transformer backbone; the conv/mel
frontend is a stub: the encoder takes precomputed frame embeddings
(batch, 1500, 384) [arXiv:2212.04356].  Counterpart of
`repro/configs/whisper_tiny.py`."""
from repro_torch.configs.base import (AttentionConfig, EncoderConfig,
                                      ModelConfig)

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                  # decoder layers
    d_model=384,
    d_ff=1536,
    vocab_size=51865,
    attn=AttentionConfig(n_heads=6, n_kv_heads=6, head_dim=64),
    encoder=EncoderConfig(n_layers=4, n_ctx=1500, frontend="stub"),
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    tie_embeddings=True,
    pos_embedding="learned",
    max_seq_len=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="data",
    source="arXiv:2212.04356 (Robust Speech Recognition / Whisper)",
)
