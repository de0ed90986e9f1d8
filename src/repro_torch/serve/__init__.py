"""Serving runtime of the port: the lock-step KV-cache decode engine."""

from repro_torch.serve.engine import ServeEngine

__all__ = ["ServeEngine"]
