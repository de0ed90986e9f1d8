"""PyTorch/CUDA port of the ``repro`` model and kernel stack.

It keeps the JAX package's module names and public layouts (NHWC
activations and HWIO conv weights for the CNN, ``(B, S, H, hd)`` attention
and ``(d_in, d_out)`` weights for the LM, parameters as nested dicts with
the same keys) and imports neither JAX nor ``repro``.  Entry points run on
the GPU unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for, explicitly or by default, and no card is
    present; a CPU run has to be requested by name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
