"""The checks the scan kernels' wrappers share: a wrapper raises on any
operand its kernel does not take, instead of launching on it."""

from __future__ import annotations

import torch

INDEX_LIMIT = 2**31      # the kernels index with 32-bit ints


def check_f32_operands(op: str, operands: dict[str, torch.Tensor],
                       shapes: dict[str, tuple[int, ...]]) -> None:
    """Every operand on the first one's device, float32, contiguous, of the
    shape ``shapes`` gives it (where it gives one) and with fewer than
    2**31 elements; the first one on a CUDA device."""
    first, lead = next(iter(operands.items()))
    if lead.device.type != "cuda":
        raise ValueError(f"{op}_kernel runs on CUDA tensors, {first} is on "
                         f"{lead.device}")
    for name, t in operands.items():
        if t.device != lead.device:
            raise ValueError(f"{op}: {name} is on {t.device}, {first} on "
                             f"{lead.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: the kernel takes float32 only, {name} "
                            f"is {t.dtype}")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if t.numel() >= INDEX_LIMIT:
            raise ValueError(f"{op}: {name} has {t.numel()} elements, the "
                             f"kernel indexes below {INDEX_LIMIT}")
