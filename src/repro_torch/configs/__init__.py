"""Model configurations of the port: its own copy of the ``ModelConfig``
fields the ported paths read, and ``get_config`` for the configs it serves
(``resnet18`` and every model of the JAX registry, whisper-large-v3's
encoder-decoder included, with their ``-smoke`` reductions), and
``ARCH_REGISTRY``, the JAX registry's list of LMs."""

from repro_torch.configs.base import ARCH_REGISTRY, ModelConfig, get_config

__all__ = ["ModelConfig", "get_config", "ARCH_REGISTRY"]
