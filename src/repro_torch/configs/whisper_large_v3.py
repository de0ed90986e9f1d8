"""Whisper-large-v3 backbone [arXiv:2212.04356; unverified]: enc-dec
transformer; conv audio frontend is a STUB (the caller provides
precomputed frame embeddings).  32L(dec) d_model=1280 20H d_ff=5120
vocab=51866; encoder 32L over 1500 frames."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    encoder_layers=32,
    encoder_seq_len=1500,     # 30 s of audio at 50 Hz after conv frontend
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
    mlp_activation="gelu",
    dtype="bfloat16",
    param_dtype="bfloat16",
)
