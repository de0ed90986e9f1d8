"""ResNet18 through the PyTorch/CUDA port: the numerics half of
``examples/resnet_pim_ppa.py``.

1. run ResNet18 monolithically and as the paper's fused groups: the
   outputs must match (fusion is an execution-order change);
2. run the stem CONV+BN+ReLU through ``ops.fused_conv`` (the fused-conv
   kernel on the card) and compare it with its plain PyTorch version.

The PIM PPA table stays in the JAX example: it comes from the PIM
framework (``repro.experiment``), which the port does not import.

Run:  PYTHONPATH=src python examples/resnet_pim_torch.py         # card
      PYTHONPATH=src python examples/resnet_pim_torch.py --cpu   # plain
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_conv_ref
from repro_torch.models import resnet as R


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    net = R.ResNet18(1000, seed=args.seed, device=device)
    g = torch.Generator().manual_seed(args.seed)
    x = torch.randn(2, 96, 96, 3, generator=g).to(device)

    y_mono = net(x)
    y_fused = net.forward_fused_groups(x)
    np.testing.assert_allclose(y_mono.cpu().numpy(), y_fused.cpu().numpy(),
                               atol=1e-4)
    print(f"fused-group execution == monolithic ✓ (logits "
          f"{tuple(y_mono.shape)}, on {device})")

    bn = net.folded["bn1"]
    kw = dict(stride=2, padding=3, relu=True)
    y_kernel = ops.fused_conv(x, net.folded["conv1"], bn["scale"],
                              bn["shift"], **kw)
    ref = fused_conv_ref(x, net.folded["conv1"], bn["scale"], bn["shift"],
                         **kw)
    np.testing.assert_allclose(y_kernel.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-3)
    route = "the fused-conv kernel" if device.type == "cuda" else \
        "the plain path"
    print(f"fused CONV_BN_RELU ({route}) == plain PyTorch reference ✓")
    print("PIM PPA table: run examples/resnet_pim_ppa.py (the PIM framework, "
          "repro.experiment, is not part of the port)")


if __name__ == "__main__":
    main()
