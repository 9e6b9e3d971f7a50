"""DeepSeek-V3-671B — MLA, 1 shared + 256 routed experts top-8
[arXiv:2412.19437].  Counterpart of `repro/configs/deepseek_v3_671b.py`,
field for field.  The reference names an MTP head in its docstring but
has no MTP code, so neither has the port.  The FL client axis is "pod":
per-client copies do not fit one pod (the reference's DESIGN.md §3)."""
from repro_torch.configs.base import (AttentionConfig, MLAConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    d_ff=2048,                   # per-routed-expert width
    vocab_size=129280,
    attn=AttentionConfig(
        n_heads=128, n_kv_heads=128, head_dim=128,
        rope_theta=10000.0,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128)),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048,
                  n_shared_experts=1, n_dense_layers=3, dense_d_ff=18432,
                  capacity_factor=1.25, router_aux_coef=0.001),
    activation="silu",
    gated_mlp=True,
    norm="rmsnorm",
    tie_embeddings=False,
    max_seq_len=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fl_client_axis="pod",
    source="arXiv:2412.19437 (DeepSeek-V3 Technical Report)",
)
