"""Where the xlstm-1.3b prefill on the card leaves its plain self, layer by
layer (one NVIDIA GPU, random weights from seed 0, 1×2048 tokens):

    python3 xlstm_drift.py

Walks the 48 blocks twice side by side, once through the kernels and once
under ``ops.plain()``, in bf16 and then in f32.  For each block it prints
the local difference (the plain block fed the kernel path's own input: what
the block itself adds) and the accumulated one (each path fed its own
previous output), and for each mLSTM block in bf16 the mLSTM-scan kernel
against ``mlstm_ref`` on that block's own q, k, v and gates.  Then the
logits of both paths.  ``chip_smoke.py`` cites these numbers for why its
bf16 xLSTM prefill is printed, not held, against its plain self.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED, TOKENS_SEED, SEQ = 0, 3, 2048     # chip_smoke.py's prefill


def scan_check(cfg, lp: dict, x: torch.Tensor) -> str:
    """The kernel against the plain recurrence on this block's inputs."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan_kernel
    from repro_torch.kernels.ref import mlstm_ref
    from repro_torch.models.layers import rmsnorm
    Bt, S, _ = x.shape
    H = cfg.num_heads
    P = cfg.d_model // H
    xin, c = rmsnorm(lp["ln"], x, cfg.norm_eps), lp["cell"]
    q = (xin @ c["wq"]).reshape(Bt, S, H, P).float() / math.sqrt(P)
    k = (xin @ c["wk"]).reshape(Bt, S, H, P).float()
    v = (xin @ c["wv"]).reshape(Bt, S, H, P).float()
    args = (q, k, v, xin.float() @ c["w_i"], xin.float() @ c["w_f"])
    ref = mlstm_ref(*args)
    err = (mlstm_scan_kernel(*args) - ref).abs().max().item()
    return f"; scan {err:.2e} at |h| <= {ref.abs().max().item():.2f}"


def walk(cfg) -> None:
    from repro_torch.kernels import ops
    from repro_torch.models import blocks as B
    from repro_torch.models import build_model
    from repro_torch.models.api import _embed, _head, _layer, xlstm_units
    model = build_model(cfg)
    params = model.init(seed=SEED).params
    g = torch.Generator(device="cuda").manual_seed(TOKENS_SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=g,
                         device="cuda")
    U, K = xlstm_units(cfg)
    x = _embed(params, cfg, toks).to(getattr(torch, cfg.dtype))
    xp = x.clone()
    layer = 0
    for u in range(U):
        units = [("mlstm", B.mlstm_block, _layer(_layer(params["mlstm"], u),
                                                 k)) for k in range(K)]
        units.append(("slstm", B.slstm_block, _layer(params["slstm"], u)))
        for kind, block, lp in units:
            extra = (scan_check(cfg, lp, x)
                     if kind == "mlstm" and cfg.dtype == "bfloat16" else "")
            y = block(lp, x, cfg)
            with ops.plain():
                y_local = block(lp, x, cfg)
                yp = block(lp, xp, cfg)
            print(f"[drift] {cfg.dtype} layer {layer:2d} {kind}: local "
                  f"{(y - y_local).abs().max().item():.3e}, accumulated "
                  f"{(y - yp).abs().max().item():.3e}, |x| <= "
                  f"{y.float().abs().max().item():.2f}{extra}", flush=True)
            x, xp, layer = y, yp, layer + 1
    logits, plain = _head(params, cfg, x), _head(params, cfg, xp)
    last = (logits[0, -1] - plain[0, -1]).abs().max().item()
    print(f"[drift] {cfg.dtype} logits: {last:.3e} at the last position, "
          f"{(logits - plain).abs().max().item():.3e} at any, |logit| <= "
          f"{plain.abs().max().item():.3f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("xlstm_drift: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    cfg = get_config("xlstm-1.3b")
    print(torch.cuda.get_device_name(0))
    for c in (cfg, dataclasses.replace(cfg, dtype="float32",
                                       param_dtype="float32")):
        t0 = time.perf_counter()
        walk(c)
        print(f"[drift] {c.dtype} walk in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
