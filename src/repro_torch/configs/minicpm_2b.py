"""MiniCPM-2B [arXiv:2404.06395; hf]: llama-like dense decoder trained with
the WSD schedule.  40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10000.0,
    tie_embeddings=True,
    mlp_activation="silu",
    dtype="bfloat16",
    param_dtype="bfloat16",
    lr_schedule="wsd",
)
