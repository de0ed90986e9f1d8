"""Carries parameters made by the JAX package into the port.

The layouts are the same on both sides (HWIO conv weights, ``(d_in,
d_out)`` dense weights, stacked decoder layers beside an unstacked
``dense0``, ``(E, d_in, d_out)`` expert weights, hybrid and xLSTM units,
stacked encoder and decoder layers, nested dicts with the same keys), so
this is a structured copy, checked key by key and shape by shape against
the tree the port's own ``init`` makes on the ``meta`` device.
bf16 leaves (``ml_dtypes.bfloat16`` in numpy, which ``torch`` cannot take)
are carried bit for bit through their 16-bit pattern.  ``state_from_jax``
carries a whole train state the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.api import lm_family
from repro_torch.models.resnet import init_resnet18


def _tensor(arr: np.ndarray, where: str, device: torch.device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)   # the same 16 bits
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if arr.dtype.kind != "f":
        raise TypeError(f"params_from_jax: {where} has dtype {arr.dtype}"
                        ", expected floating point")
    return torch.tensor(arr, device=device)


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
        out[k] = _tensor(arr, where, device)
    return out


def _ref_tree(cfg: ModelConfig | None, tree: dict[str, Any]) -> dict:
    """The port's own tree for ``cfg`` on the ``meta`` device."""
    if cfg is None or cfg.family == "cnn":
        if not isinstance(tree, dict) or "fc_b" not in tree:
            raise KeyError("params_from_jax: not a ResNet18 tree (no 'fc_b')")
        num_classes = int(np.asarray(tree["fc_b"]).shape[0])
        return init_resnet18(torch.Generator(), num_classes, device="meta")
    return lm_family(cfg)[0].init_params(torch.Generator(), cfg,
                                         device="meta")


def params_from_jax(tree: dict[str, Any], device=None,
                    cfg: ModelConfig | None = None) -> dict[str, Any]:
    """``tree``: the nested dict of arrays from the JAX package (numpy or
    anything ``np.asarray`` takes): ``repro.models.resnet.init_resnet18``'s
    when ``cfg`` is None or a CNN config, else the ``init`` of
    ``repro.models.build_model(cfg)``: the tree of the family that
    ``models.api.lm_family`` picks, as that function picks it (the
    encoder-decoder, hybrid or xLSTM tree, else the decoder-only one).
    Returns the same tree as tensors on ``device`` (default ``cuda``) in
    the arrays' own dtypes, so an MoE tree's f32 ``router`` stays f32
    beside bf16 experts; raises on a missing or extra key or a wrong
    shape."""
    device = resolve_device(device)
    return _copy(tree, _ref_tree(cfg, tree), device, "")


def state_from_jax(state: dict[str, Any], cfg: ModelConfig,
                   device=None) -> dict[str, Any]:
    """A JAX train state (``repro.train.trainer.init_train_state``'s, or
    one restored from its checkpoint) as the port's: ``{"params", "opt":
    {"m", "v", "step"}}`` and ``"ef"`` when present.  ``state`` holds
    numpy arrays (or anything ``np.asarray`` takes); ``params``, ``m``,
    ``v`` and ``ef`` are checked key by key and shape by shape against the
    port's tree for ``cfg`` and go to ``device`` (default ``cuda``) in
    their own dtypes (bf16 bit for bit), the params with
    ``requires_grad``; ``step`` becomes the port's host-side int32
    scalar."""
    device = resolve_device(device)
    extra = state.keys() - {"params", "opt", "ef"}
    if extra or {"params", "opt"} - state.keys():
        raise KeyError(f"state_from_jax: keys {sorted(state)}, expected "
                       f"params, opt and optionally ef")
    ref = _ref_tree(cfg, state["params"])
    out = {"params": _copy(state["params"], ref, device, "params")}
    for leaf in L.flatten_tree(out["params"]).values():
        leaf.requires_grad_(True)
    opt = state["opt"]
    out["opt"] = {"m": _copy(opt["m"], ref, device, "opt/m"),
                  "v": _copy(opt["v"], ref, device, "opt/v"),
                  "step": torch.tensor(int(np.asarray(opt["step"])),
                                       dtype=torch.int32)}
    if "ef" in state:
        out["ef"] = _copy(state["ef"], ref, device, "ef")
    return out
