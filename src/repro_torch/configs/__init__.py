"""Model configurations of the port: its own copy of the ``ModelConfig``
fields the CNN path reads, and ``get_config`` for the configs it serves."""

from repro_torch.configs.base import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
