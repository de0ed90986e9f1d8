"""The bf16 flash backward's error at gemma2-2b's training layers, on one
NVIDIA GPU.

    python3 flash_bwd_precision.py [SRC]

Runs the bf16 flash forward and backward kernels of the port at ``SRC``
(default: ``src`` beside this file; another checkout's ``src`` measures
that checkout's kernels) at gemma2-2b's two training layers (1x8192, 8
query and 4 KV heads of 256, softcap 50; causal, and with the 4096 window;
phase 34's inputs) and holds dq, dk and dv against the gradient in f64 of
the same bf16 values, per KV head: the share of the limit (half a bf16 ulp
of |g| + 2e-5, as phase 34 of ``chip_smoke.py``) that the kernel uses, and
that P and dS use when split into two or three bf16 parts (hi = bf16(x),
then the rest likewise), summed exactly in f64 and rounded once to bf16.
The kernel against the two-part split tells its sums' error apart from the
split's.  Printed, not held.  Exits 1 without a card.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SEED = 905          # phase 34's seed for the first of these shapes
B, H, KV, S, D, SOFTCAP = 1, 8, 4, 8192, 256, 50.0
WINDOWS = (0, 4096)


def split(x: torch.Tensor, parts: int) -> torch.Tensor:
    """x (f64, taken in f32 first) as the sum of ``parts`` bf16 parts."""
    rest, total = x.float(), torch.zeros_like(x)
    for _ in range(parts):
        part = rest.bfloat16().float()
        total += part.double()
        rest = rest - part
    return total


def used(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest share of the limit an element of ``got`` uses."""
    lim = 2.0**-8 * want.abs() + 2e-5
    return ((got - want).abs() / lim).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_precision: no CUDA device", file=sys.stderr)
        return 1
    src = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src.resolve()))
    from repro_torch.kernels import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = torch.cuda.get_device_name(0)
    print(f"flash_bwd_precision: the kernels of {src}, {smi}")
    G, scale = H // KV, 1 / math.sqrt(D)
    for n, window in enumerate(WINDOWS):
        g = torch.Generator(device="cuda").manual_seed(SEED + n)
        q, k, v = (torch.randn(B, S, heads, D, generator=g,
                               device="cuda").bfloat16()
                   for heads in (H, KV, KV))
        do = torch.randn(B, S, H, D, generator=g, device="cuda").bfloat16()
        q, k, v, do = (t.transpose(1, 2).reshape(-1, S, D).contiguous()
                       for t in (q, k, v, do))
        kw = dict(causal=True, window=window, softcap=SOFTCAP)
        out, lse, lo = FA.flash_attention_kernel(q, k, v, **kw, stats=True)
        dq, dk, dv = FA.flash_attention_backward_kernel(
            q, k, v, out, lse, do, out_lo=lo, **kw)
        i = torch.arange(S, device="cuda")
        mask = i[None, :] <= i[:, None]
        if window:
            mask &= i[None, :] > i[:, None] - window
        for kvh in range(KV):
            K, V = k[kvh].double(), v[kvh].double()
            # exact, two parts, three parts: dq of each head, dk, dv
            grads = {p: [[], torch.zeros(S, D, dtype=torch.float64,
                                         device="cuda"),
                         torch.zeros(S, D, dtype=torch.float64,
                                     device="cuda")] for p in (0, 2, 3)}
            for h in range(kvh * G, (kvh + 1) * G):
                s = q[h].double() @ K.T
                t = torch.tanh(s * scale / SOFTCAP)
                x = torch.where(mask, SOFTCAP * t, -1e30)
                p = torch.exp(x - torch.logsumexp(x, dim=-1)[:, None])
                d0 = do[h].double()
                dp = d0 @ V.T
                ds = p * (dp - (p * dp).sum(-1)[:, None]) \
                    * (1 - t * t) * scale
                del s, t, x, dp
                for parts, acc in grads.items():
                    pp = p if parts == 0 else split(p, parts)
                    dd = ds if parts == 0 else split(ds, parts)
                    acc[0].append(dd @ K)
                    acc[1] += dd.T @ q[h].double()
                    acc[2] += pp.T @ d0
                    del pp, dd
                del p, ds, d0
            exact = grads[0]
            want = [torch.stack(exact[0]), exact[1], exact[2]]
            kernel = [dq[kvh * G:(kvh + 1) * G].double(), dk[kvh].double(),
                      dv[kvh].double()]
            line = [f"window {window} KV head {kvh}: kernel "
                    + " ".join(f"d{n_} {used(a, w):.3f}"
                               for n_, a, w in zip("qkv", kernel, want))]
            for parts in (2, 3):
                acc = grads[parts]
                got = [torch.stack(acc[0]), acc[1], acc[2]]
                line.append(f"{parts} parts " + " ".join(
                    f"d{n_} {used(a.float().bfloat16().double(), w):.3f}"
                    for n_, a, w in zip("qkv", got, want)))
            print("; ".join(line), flush=True)
            del grads, exact, want, kernel
            torch.cuda.empty_cache()
        del q, k, v, do, out, lse, lo, dq, dk, dv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
