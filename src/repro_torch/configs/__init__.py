"""Model configurations of the port: its own copy of the ``ModelConfig``
fields the ported paths read, and ``get_config`` for the configs it serves
(``resnet18``, ``gemma2-2b``, ``zamba2-2.7b``, ``xlstm-1.3b`` and their
``-smoke`` reductions)."""

from repro_torch.configs.base import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
