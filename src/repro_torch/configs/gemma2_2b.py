"""Gemma2-2B [arXiv:2408.00118; hf]: local(4096)+global alternating
attention, logit softcapping, sandwich norms.  26L d_model=2304 8H (kv=4)
d_ff=9216 vocab=256000."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10000.0,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=True,
    post_attn_norm=True,
    post_mlp_norm=True,
    tie_embeddings=True,
    scale_embed_by_sqrt_dim=True,
    mlp_activation="gelu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
