"""Phi-3-mini 3.8B [arXiv:2404.14219; unverified]: dense decoder,
RoPE + SwiGLU, MHA-style GQA (kv=32).  32L d_model=3072 32H d_ff=8192
vocab=32064."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    tie_embeddings=False,
    mlp_activation="silu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
