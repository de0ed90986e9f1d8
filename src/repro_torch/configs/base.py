"""The fields of ``ModelConfig`` that the ported CNN path reads, under the
same names as in the JAX package's config, plus ``get_config``."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm", "cnn"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    vocab_size: int = 0               # classifier classes for the CNN
    param_dtype: str = "float32"


_MODULE_FOR = {"resnet18": "repro_torch.configs.resnet18"}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULE_FOR:
        raise KeyError(
            f"no port of config {name!r}; the port serves {sorted(_MODULE_FOR)}"
            " (the LM configs arrive with ROADMAP queue 1, items 7-11)")
    return importlib.import_module(_MODULE_FOR[name]).CONFIG
