"""PyTorch model zoo of the port: parameter dicts + functional forwards.

``build_model(cfg, device=None)`` returns a :class:`repro_torch.models.api.Model`
bundle with ``init``, ``forward``, ``init_cache`` and ``decode_step`` (and,
for the encoder-decoder, ``encode`` and ``fill_cross_cache``).
"""

from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
