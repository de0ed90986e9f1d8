"""Carries parameters made by the JAX package into the port.

The layouts are the same on both sides (HWIO conv weights, nested dicts
with the same keys), so this is a structured copy, checked key by key and
shape by shape against the port's own ``init_resnet18``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.resnet import init_resnet18


def _copy(tree: dict[str, Any], ref: dict[str, Any], device: torch.device,
          path: str) -> dict[str, Any]:
    if not isinstance(tree, dict):
        raise TypeError(f"params_from_jax: {path or 'tree'} is "
                        f"{type(tree).__name__}, expected a dict")
    missing = ref.keys() - tree.keys()
    extra = tree.keys() - ref.keys()
    if missing or extra:
        raise KeyError(f"params_from_jax: at {path or 'top level'} missing "
                       f"{sorted(missing)}, extra {sorted(extra)}")
    out: dict[str, Any] = {}
    for k, want in ref.items():
        where = f"{path}/{k}" if path else k
        if isinstance(want, dict):
            out[k] = _copy(tree[k], want, device, where)
            continue
        arr = np.asarray(tree[k])
        if arr.shape != tuple(want.shape):
            raise ValueError(f"params_from_jax: {where} has shape {arr.shape}"
                             f", expected {tuple(want.shape)}")
        if arr.dtype.kind != "f":
            raise TypeError(f"params_from_jax: {where} has dtype {arr.dtype}"
                            ", expected floating point")
        out[k] = torch.tensor(arr, device=device)
    return out


def params_from_jax(tree: dict[str, Any], device=None) -> dict[str, Any]:
    """``tree``: the nested dict of arrays from
    ``repro.models.resnet.init_resnet18`` (numpy or anything
    ``np.asarray`` takes).  Returns the same tree as tensors on ``device``
    (default ``cuda``); raises on a missing or extra key or a wrong shape."""
    device = resolve_device(device)
    if not isinstance(tree, dict) or "fc_b" not in tree:
        raise KeyError("params_from_jax: not a ResNet18 tree (no 'fc_b')")
    num_classes = int(np.asarray(tree["fc_b"]).shape[0])
    ref = init_resnet18(torch.Generator(), num_classes, device="meta")
    return _copy(tree, ref, device, "")
