"""Qwen3-32B [hf:Qwen/Qwen3-8B family; hf]: dense decoder with QK-Norm,
GQA kv=8.  64L d_model=5120 64H d_ff=25600 vocab=151936."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    rope_theta=1000000.0,
    qk_norm=True,
    tie_embeddings=False,
    mlp_activation="silu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
