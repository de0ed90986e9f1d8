"""xLSTM-1.3B [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks.
48L d_model=2048 4H d_ff=0 (block-internal projections) vocab=50304.
An sLSTM block every 4 layers, the rest mLSTM, as in the JAX package's
config.  The cells take P = d_model // num_heads = 512 per head."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,                   # xLSTM blocks carry their own up/down proj
    vocab_size=50304,
    ssm_expand=2,
    ssm_chunk=128,
    xlstm_slstm_every=4,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
