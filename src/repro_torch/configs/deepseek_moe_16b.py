"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64
routed experts top-6, first layer dense.  28L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=102400."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,              # dense first-layer FFN hidden
    vocab_size=102400,
    moe_num_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_num_shared_experts=2,
    first_dense_layers=1,
    tie_embeddings=False,
    mlp_activation="silu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
