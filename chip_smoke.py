"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:
1. card: needs CUDA; prints the card's name and power limit; TF32 off.
2. build: compiles the hand-written kernels from ``src/repro_torch/kernels/
   csrc`` with nvcc for sm_90a; prints the build time and ptxas's report.
3. kernel check: the fused-conv kernel against its plain PyTorch version on
   the card, at every distinct conv shape of ResNet18 at batch 8.
4. model path: ResNet18 at the paper's width (224×224×3, 1000 classes,
   random weights from a seed) built through ``build_model`` serves 4
   requests of 8 images, then runs ``forward_fused_groups``; the logits are
   finite, the two forwards agree, the first request agrees with the plain
   forward on the CPU, and each forward made exactly 20 kernel launches.
5. timings with CUDA events: per conv shape the kernel, its plain version,
   the library conv (``torch.nn.functional.conv2d`` without the epilogue; a
   yardstick only, the port never calls it) and the bound; the forward; then
   device time by kernel and the idle share, from torch.profiler.
6. prints the ``kernels`` JSON line, 7. the final ``{"ok": true, ...}`` line.
The full record goes to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 8
IMAGE_HW = 224
REQUESTS = 4
CONVS_PER_FORWARD = 20
# f32 sums taken in another order than the plain version's:
KERNEL_RTOL = 1e-4    # max|kernel − plain| ≤ KERNEL_RTOL · max|plain|, per conv
LOGITS_RTOL = 1e-3    # the same over 20 layers, GPU kernels vs plain on the CPU
FUSED_RTOL = 1e-6     # forward_fused_groups runs the same launches as forward
PEAK_F32_OPS = 67e12  # H100 SXM, f32 outside the tensor cores, per second
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes per second
TIMING_ITERS = 20
PROFILE_FORWARDS = 5

# Distinct convs of ResNet18 at 224²: (name, launches per forward, input hw,
# Cin, Cout, k, stride, padding, relu, residual).  Stage n's first block has
# conv1 at stride 2, the downsample, and conv2 with the ADD_RELU epilogue;
# its second block has conv1 and conv2 at stride 1.
CONV_SHAPES = [("stem_7x7s2", 1, 224, 3, 64, 7, 2, 3, True, False),
               ("s1_3x3", 2, 56, 64, 64, 3, 1, 1, True, False),
               ("s1_3x3_add", 2, 56, 64, 64, 3, 1, 1, True, True)]
for _si, (_hw, _cin, _cout) in enumerate([(56, 64, 128), (28, 128, 256),
                                          (14, 256, 512)], start=2):
    _s = f"s{_si}"
    CONV_SHAPES += [
        (f"{_s}_3x3s2", 1, _hw, _cin, _cout, 3, 2, 1, True, False),
        (f"{_s}_down_1x1s2", 1, _hw, _cin, _cout, 1, 2, 0, False, False),
        (f"{_s}_3x3", 1, _hw // 2, _cout, _cout, 3, 1, 1, True, False),
        (f"{_s}_3x3_add", 2, _hw // 2, _cout, _cout, 3, 1, 1, True, True)]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    return smi


def build() -> float:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.library_path()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s")
    print(path.with_suffix(".log").read_text().strip())
    return secs


def conv_inputs(i: int, shape):
    _, _, hw, cin, cout, k, s, p, _, res = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 100 + i)

    def randn(*size):
        return torch.randn(size, generator=g, device="cuda")
    x = randn(BATCH, hw, hw, cin)
    w = randn(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5
    scale = 1 + 0.1 * randn(cout)
    shift = 0.1 * randn(cout)
    oh = (hw + 2 * p - k) // s + 1
    residual = randn(BATCH, oh, oh, cout) if res else None
    return x, w, scale, shift, residual


def kernel_check() -> list[dict]:
    from repro_torch.kernels.fused_conv import fused_conv_kernel
    from repro_torch.kernels.ref import fused_conv_ref
    rows = []
    for i, shape in enumerate(CONV_SHAPES):
        name, count, _, _, _, _, s, p, relu, _ = shape
        x, w, scale, shift, res = conv_inputs(i, shape)
        kw = dict(stride=s, padding=p, relu=relu, residual=res)
        out = fused_conv_kernel(x, w, scale, shift, **kw)
        torch.cuda.synchronize()
        ref = fused_conv_ref(x, w, scale, shift, **kw)
        check(out.shape == ref.shape, f"{name}: shape {out.shape} vs "
              f"{ref.shape}")
        err, rel = rel_err(out, ref)
        print(f"[check] {name:16s} out {tuple(out.shape)} max_abs_err "
              f"{err:.3e} rel {rel:.3e}")
        check(rel <= KERNEL_RTOL, f"{name}: kernel vs plain rel err {rel:.3e}"
              f" > {KERNEL_RTOL}")
        rows.append({"name": name, "per_forward": count,
                     "out": list(out.shape), "max_abs_err": err,
                     "rel_err": rel})
    return rows


def perturb_bn(tree: dict, g: torch.Generator) -> None:
    """Moves every BN off the identity, so that folding it matters."""
    for v in tree.values():
        if isinstance(v, dict) and "var" in v:
            c = v["var"].shape[0]
            v["mean"].copy_(0.1 * torch.randn(c, generator=g))
            v["var"].copy_(0.5 + torch.rand(c, generator=g))
            v["scale"].copy_(1 + 0.1 * torch.randn(c, generator=g))
            v["bias"].copy_(0.1 * torch.randn(c, generator=g))
        elif isinstance(v, dict):
            perturb_bn(v, g)


def model_path() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_conv as fc
    from repro_torch.models import build_model
    from repro_torch.models import resnet as R
    cfg = get_config("resnet18")
    model = build_model(cfg)
    check(model.device.type == "cuda", f"built on {model.device}")
    params = R.init_resnet18(torch.Generator().manual_seed(SEED),
                             cfg.vocab_size, device=model.device)
    perturb_bn(params, torch.Generator().manual_seed(SEED + 1))
    net = R.ResNet18(cfg.vocab_size, params=params, device=model.device)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    requests = [torch.randn(BATCH, IMAGE_HW, IMAGE_HW, 3, generator=g,
                            device="cuda") for _ in range(REQUESTS)]

    fc.launches = 0
    logits, latency_ms = [], []
    for x in requests:
        before = fc.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = model.forward(net, {"images": x})
        torch.cuda.synchronize()
        latency_ms.append((time.perf_counter() - t0) * 1e3)
        check(fc.launches - before == CONVS_PER_FORWARD,
              f"{fc.launches - before} fused-conv launches in a forward")
        logits.append(out)
    before = fc.launches
    fused = net.forward_fused_groups(requests[0])
    torch.cuda.synchronize()
    check(fc.launches - before == CONVS_PER_FORWARD,
          f"{fc.launches - before} launches in forward_fused_groups")
    launches = fc.launches
    print(f"[model] {REQUESTS} requests of {BATCH}x{IMAGE_HW}x{IMAGE_HW}x3, "
          f"{cfg.vocab_size} classes: latency ms "
          f"{[round(t, 3) for t in latency_ms]}, fused_conv launches "
          f"{launches} ({CONVS_PER_FORWARD} per forward)")

    for out in logits:
        check(tuple(out.shape) == (BATCH, cfg.vocab_size),
              f"logits shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite logits")
    _, fused_rel = rel_err(fused, logits[0])
    check(fused_rel <= FUSED_RTOL,
          f"forward_fused_groups vs forward rel err {fused_rel:.3e}")
    cpu_params = R.fold_bn(_to_cpu(net.params))
    t0 = time.perf_counter()
    ref = R.forward(cpu_params, requests[0].cpu())
    ref_s = time.perf_counter() - t0
    err, rel = rel_err(logits[0].cpu(), ref)
    print(f"[model] fused groups vs forward rel err {fused_rel:.3e}; kernel "
          f"path vs plain CPU forward ({ref_s:.1f} s) max_abs_err {err:.3e} "
          f"rel {rel:.3e}; logits max |.| {ref.abs().max().item():.3e}")
    check(rel <= LOGITS_RTOL, f"logits vs plain rel err {rel:.3e} > "
          f"{LOGITS_RTOL}")
    return {"net": net, "x": requests[0], "launches": launches,
            "request_latency_ms": latency_ms, "logits_max_abs_err": err,
            "logits_rel_err": rel, "fused_groups_rel_err": fused_rel}


def _to_cpu(tree: dict) -> dict:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


def touched(n: int, k: int, s: int, p: int) -> int:
    """How many of n input rows (or columns) a k-wide window at stride s and
    padding p reads: a 1x1/s2 conv reads every other one."""
    o = (n + 2 * p - k) // s + 1
    return len({i * s - p + r for i in range(o) for r in range(k)}
               & set(range(n)))


def bounds(shape) -> dict:
    _, _, hw, cin, cout, k, s, p, relu, res = shape
    oh = (hw + 2 * p - k) // s + 1
    m, kk = BATCH * oh * oh, k * k * cin
    ops = 2 * m * cout * kk + m * cout * (2 + int(res) + int(relu))
    nbytes = 4 * (BATCH * touched(hw, k, s, p) ** 2 * cin + kk * cout
                  + 2 * cout + m * cout * (1 + int(res)))
    ops_ms, bytes_ms = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def timings(rows: list[dict], model: dict) -> dict:
    from repro_torch.kernels.fused_conv import fused_conv_kernel
    from repro_torch.kernels.ref import fused_conv_ref
    for i, (shape, row) in enumerate(zip(CONV_SHAPES, rows)):
        _, _, _, _, _, _, s, p, relu, _ = shape
        x, w, scale, shift, res = conv_inputs(i, shape)
        kw = dict(stride=s, padding=p, relu=relu, residual=res)
        x_nchw = x.permute(0, 3, 1, 2)          # channels-last view, no copy
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row.update(bounds(shape))
        row["ms"] = cuda_ms(lambda: fused_conv_kernel(x, w, scale, shift,
                                                      **kw))
        row["plain_ms"] = cuda_ms(lambda: fused_conv_ref(x, w, scale, shift,
                                                         **kw))
        row["library_ms"] = cuda_ms(lambda: F.conv2d(x_nchw, w_lib, stride=s,
                                                     padding=p))
        print(f"[time] {row['name']:16s} x{row['per_forward']} kernel "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f}  library "
              f"{row['library_ms']:.4f}  bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}; {row['ops'] / row['ms'] / 1e9:.1f} "
              f"TFLOP/s)")
    net, x = model["net"], model["x"]
    fwd_ms = cuda_ms(lambda: net(x), iters=10)
    print(f"[time] forward batch {BATCH} at {IMAGE_HW}²: {fwd_ms:.3f} ms "
          f"(CUDA events, mean of 10)")
    return {"forward_ms": fwd_ms}


def profile(model: dict) -> dict:
    """Device time by kernel name and the device's idle share over a window
    of back-to-back forwards, from torch.profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, record_function
    net, x = model["net"], model["x"]
    net(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function("forwards"):
            for _ in range(PROFILE_FORWARDS):
                net(x)
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events if e.name == "forwards").time_range
    spans = sorted((max(e.time_range.start, window.start),
                    min(e.time_range.end, window.end), e.name)
                   for e in events   # the annotation also shows on the device
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name != "forwards")
    if not spans:
        print("[profile] the profiler recorded no device time: not measured")
        return {"profile": None}
    busy, reach, by_name = 0.0, window.start, {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + end - start)
    wall = window.end - window.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    result = {"forwards": PROFILE_FORWARDS, "window_us": wall,
              "device_busy_us": busy, "idle_share": 1 - busy / wall,
              "kernels": [{"name": k[:80], "count": n, "us": t}
                          for k, (n, t) in top]}
    print(f"[profile] {PROFILE_FORWARDS} forwards: window {wall:.0f} us, "
          f"device busy {busy:.0f} us, idle share {result['idle_share']:.3f}")
    for k in result["kernels"]:
        print(f"[profile]   {k['us'] / PROFILE_FORWARDS:9.1f} us/forward "
              f"x{k['count'] // PROFILE_FORWARDS:<3d} {k['name']}")
    return {"profile": result}


def per_forward(rows: list[dict], key: str) -> float:
    return sum(r["per_forward"] * r[key] for r in rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = card()
    build_s = build()
    rows = kernel_check()
    model = model_path()
    fwd = timings(rows, model)
    fwd.update(profile(model))

    check(sum(r["per_forward"] for r in rows) == CONVS_PER_FORWARD,
          "CONV_SHAPES do not add up to one forward")
    ops_ms, bytes_ms = per_forward(rows, "ops_ms"), per_forward(rows,
                                                                "bytes_ms")
    kernels = {"kernels": [{
        "name": "fused_conv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_conv.cu",
        "replaces": "src/repro/kernels/fused_conv.py:82",
        "launches": model["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_forward(rows, "ms"),
        "plain_ms": per_forward(rows, "plain_ms"),
        "bound_ms": per_forward(rows, "bound_ms"),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": per_forward(rows, "library_ms"),
        "times_are": f"sums over the {CONVS_PER_FORWARD} launches of one "
                     f"batch-{BATCH} forward; per shape in chip_smoke.json",
    }]}
    record = {"card": smi, "torch": torch.__version__,
              "build_s": build_s, "shapes": rows, **fwd,
              **{k: v for k, v in model.items() if k not in ("net", "x")},
              **kernels}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[summary] forward {fwd['forward_ms']:.3f} ms; median request "
          f"{statistics.median(model['request_latency_ms']):.3f} ms; "
          f"fused_conv {kernels['kernels'][0]['ms']:.3f} ms per forward")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
