"""ResNet18 — the paper's own benchmark (§V), 224×224×3 input, 1000 classes."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet18",
    family="cnn",
    vocab_size=1000,          # classifier classes
    param_dtype="float32",
)
