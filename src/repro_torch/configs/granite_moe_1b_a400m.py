"""Granite-3.0-1B-A400M [hf:ibm-granite/...-base; hf]: MoE decoder,
32 experts top-8, fine-grained d_ff=512.  24L d_model=1024 16H (kv=8)
vocab=49155."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe_num_experts=32,
    moe_top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
    mlp_activation="silu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
