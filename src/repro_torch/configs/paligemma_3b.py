"""PaliGemma-3B [arXiv:2407.07726; hf]: SigLIP vision frontend (STUB —
precomputed patch embeddings via input_specs) + Gemma-2B decoder backbone.
18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed_by_sqrt_dim=True,   # gemma backbone convention
    num_prefix_tokens=256,          # SigLIP 224px/14 → 256 patch tokens (stub)
    mlp_activation="gelu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
