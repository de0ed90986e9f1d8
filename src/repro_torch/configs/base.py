"""The fields of ``ModelConfig`` that the ported paths read (the ResNet18
CNN, the decoder-only LM with its dense, MoE and VLM-prefix forms, the
Mamba2 hybrid, xLSTM, the encoder-decoder, and the trainer's
``lr_schedule``), under the same names and with the same defaults as in
the JAX package's config, plus ``get_config``."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm", "cnn"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family

    # --- backbone dimensions ---
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 → d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0               # classifier classes for the CNN

    # --- attention options ---
    rope_theta: float = 10000.0
    qk_norm: bool = False             # qwen3
    attn_softcap: float = 0.0         # gemma2 logit softcapping
    final_softcap: float = 0.0        # gemma2 final-logit softcap
    sliding_window: int = 0           # gemma2 local layers
    local_global_pattern: bool = False  # gemma2: alternate local/global
    post_attn_norm: bool = False      # gemma2 sandwich norms
    post_mlp_norm: bool = False

    # --- embedding/head ---
    tie_embeddings: bool = True
    scale_embed_by_sqrt_dim: bool = False  # gemma family
    num_prefix_tokens: int = 0        # vlm stub frontend tokens

    # --- MLP ---
    mlp_activation: str = "silu"      # silu (SwiGLU) | gelu (GeGLU)

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden (fine-grained MoE)
    moe_num_shared_experts: int = 0   # deepseek shared experts
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    first_dense_layers: int = 0       # deepseek: layer 0 is dense FFN

    # --- SSM / hybrid (zamba2: mamba2 + shared attention) ---
    ssm_state_dim: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0        # a shared attn block every N ssm layers

    # --- xLSTM ---
    xlstm_slstm_every: int = 0        # an sLSTM block every N layers (else mLSTM)

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0          # precomputed frame embeddings (stub)

    # --- norm/numerics ---
    norm_eps: float = 1e-6
    dtype: str = "float32"            # activation/computation dtype
    param_dtype: str = "float32"

    # --- training ---
    lr_schedule: str = "cosine"       # cosine | wsd

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def window_for_layer(self, i: int) -> int:
        """Sliding window size for layer i (0 = global full attention)."""
        if self.local_global_pattern and self.sliding_window:
            return self.sliding_window if i % 2 == 0 else 0
        return self.sliding_window

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests (f32 numerics);
        the same reduction as the JAX package's for the fields kept here."""
        small = dict(
            num_layers=min(self.num_layers, 4) or self.num_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2))
            if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=min(self.vocab_size, 512) if self.vocab_size else 0,
            name=self.name + "-smoke",
            dtype="float32",
            param_dtype="float32",
        )
        if self.moe_num_experts:
            small.update(moe_num_experts=4, moe_top_k=2, moe_d_ff=32,
                         moe_num_shared_experts=min(
                             self.moe_num_shared_experts, 1))
        if self.ssm_state_dim:
            small.update(ssm_state_dim=16, ssm_head_dim=16, ssm_chunk=16)
        if self.hybrid_attn_every:
            small.update(hybrid_attn_every=2)
        if self.xlstm_slstm_every:
            small.update(xlstm_slstm_every=2)
        if self.is_encoder_decoder:
            small.update(encoder_layers=2, encoder_seq_len=16)
        if self.sliding_window:
            small.update(sliding_window=8)
        if self.num_prefix_tokens:
            small.update(num_prefix_tokens=4)
        return dataclasses.replace(self, **small)


# the LMs of the JAX registry, in its order (resnet18 is served apart)
ARCH_REGISTRY = [
    "paligemma-3b",
    "phi3-mini-3.8b",
    "qwen3-32b",
    "gemma2-2b",
    "minicpm-2b",
    "zamba2-2.7b",
    "granite-moe-1b-a400m",
    "deepseek-moe-16b",
    "xlstm-1.3b",
    "whisper-large-v3",
]

_MODULE_FOR = {name: "repro_torch.configs." + name.replace("-", "_")
               .replace(".", "_")
               for name in ("resnet18", "gemma2-2b", "zamba2-2.7b",
                            "xlstm-1.3b", "deepseek-moe-16b",
                            "granite-moe-1b-a400m", "phi3-mini-3.8b",
                            "qwen3-32b", "minicpm-2b", "paligemma-3b",
                            "whisper-large-v3")}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name.endswith("-smoke"):
        name, smoke = name[: -len("-smoke")], True
    if name not in _MODULE_FOR:
        raise KeyError(
            f"no port of config {name!r}; the port serves {sorted(_MODULE_FOR)}")
    cfg: ModelConfig = importlib.import_module(_MODULE_FOR[name]).CONFIG
    return cfg.smoke() if smoke else cfg

