"""Serving example through the PyTorch/CUDA port: batched greedy decoding
against a KV cache, the counterpart of ``examples/serve_lm.py``.

Builds the reduced gemma2-style model (sliding-window + global attention,
softcaps: the serving-relevant features), feeds the prompts through the
lock-step engine, decodes new tokens, and cross-checks the engine's first
tokens against the full-sequence forward's argmax.  On the card the
forward's attention runs through the flash-attention kernel; the decode
steps run the plain attention over the cache, as in the JAX package.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py                # card
      PYTHONPATH=src python examples/serve_lm_torch.py --device cpu   # plain
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu for the plain path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gemma2-2b", smoke=True)
    model = build_model(cfg, device=device)
    net = model.init(seed=args.seed)

    rng = np.random.default_rng(args.seed)
    B, plen, new = 4, 12, 16
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, plen)))
               for _ in range(B)]

    engine = ServeEngine(model, net, batch_slots=B, max_len=plen + new)
    t0 = time.perf_counter()
    outs = engine.run_lockstep(prompts, max_new=new)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    print(f"decoded {B}x{new} tokens in {dt:.2f} s ({B * new / dt:.1f} "
          f"tok/s on {where}, host clock, first call included)")
    for i, o in enumerate(outs):
        print(f"req{i}: {o}")

    # cross-check: first generated token == argmax of the forward pass
    logits, _ = model.forward(net, {"tokens": torch.tensor(prompts)})
    expect = logits[:, -1].argmax(dim=-1).cpu().numpy()
    got = np.asarray([o[0] for o in outs])
    if not (expect == got).all():
        raise RuntimeError(f"engine's first tokens {got} differ from the "
                           f"forward's argmax {expect}")
    print("engine output matches forward argmax ✓")


if __name__ == "__main__":
    main()
