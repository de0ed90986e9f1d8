"""Zamba2-2.7B [arXiv:2411.15242; hf]: Mamba2 backbone with shared attention
blocks interleaved.  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  One attention block every 6 layers (the shared transformer
block of the paper applied at its insertion points), as in the JAX
package's config."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_conv_width=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    hybrid_attn_every=6,
    tie_embeddings=True,
    mlp_activation="silu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
