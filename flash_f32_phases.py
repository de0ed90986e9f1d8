"""Where the f32 flash forward kernel's time goes, on one NVIDIA GPU.

    python3 flash_f32_phases.py

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/
flash_attention.cu`` (the ``simt_f32`` route) into ``build/
flash_f32_phases/``: every consumer warp reads ``clock64`` between the
phases of each step (the wait for the item's Q, the wait for a K tile, S,
the softmax, the two group barriers around the P^T stores, the wait for a
V tile with the O rescale, P.V, the item's epilogue) and adds its cycles,
with its time in the kernel by ``%globaltimer``, into device counters.
Runs the copy and the uninstrumented source at the minicpm-2b f32 twin's
layer (4x1024, 36 heads of 64, causal) and at whisper-large-v3's two f32
clip shapes (1x1500 and 448 by 1500, 20 heads of 64, non-causal), checks
both against the plain version, and prints each phase's share of the
consumer warps' cycles, the SM clock, and the consumer warps' share of the
CUDA-event time.  The copy's phases add a few per cent to the kernel's
time.  Exits 1 without a card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
OUT = ROOT / "build/flash_f32_phases"
PHASES = ["item's Q", "K tile", "S", "softmax", "barrier before P^T",
          "P^T stores", "barrier after P^T", "O rescale and V tile", "P.V",
          "epilogue"]
# name, heads (B * H), S, T, causal; head dim 64
SHAPES = [("minicpm-2b_f32_twin_layer", 4 * 36, 1024, 1024, True),
          ("whisper_enc_clip", 20, 1500, 1500, False),
          ("whisper_cross_clip", 20, 448, 1500, False)]
ATOL = 2e-5     # per element, as chip_smoke.py holds the kernel


def instrumented(src: str) -> str:
    """The source with the phase clocks; raises if an anchor has moved."""
    def at(old: str, new: str) -> None:
        nonlocal src
        if src.count(old) != 1:
            raise SystemExit(f"flash_f32_phases: anchor not found once: "
                             f"{old.strip()!r}")
        src = src.replace(old, new)
    n = len(PHASES)
    at("struct Args {", f"__device__ unsigned long long g_clk[{n + 2}];\n"
       "#define TICK(k) do { unsigned long long t_ = clock64(); "
       "ph[k] += t_ - t_last; t_last = t_; } while (0)\nstruct Args {")
    at("  regs_inc<232>();\n",
       f"  regs_inc<232>();\n  unsigned long long ph[{n + 2}] = {{0}};\n"
       "  unsigned long long t_last = clock64(), c_start = t_last, g_start;\n"
       '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_start));\n')
    at("    group_sync(group);   // the item before's parts of O read\n",
       "    group_sync(group);   // the item before's parts of O read\n"
       "    TICK(0);\n")
    at("      mbar_wait(full + bk, (it / C::NBUF) & 1);\n",
       "      mbar_wait(full + bk, (it / C::NBUF) & 1);\n      TICK(1);\n")
    at("      float alpha[C::TM];\n",
       "      TICK(2);\n      float alpha[C::TM];\n")
    at("      group_sync(group);   // the last step's P.V has read P^T and "
       "alpha\n", "      TICK(3);\n      group_sync(group);   // the last "
       "step's P.V has read P^T and alpha\n      TICK(4);\n")
    at("      group_sync(group);   // P^T and alpha written\n",
       "      TICK(5);\n      group_sync(group);   // P^T and alpha written\n"
       "      TICK(6);\n")
    at("      mbar_wait(full + bv, ((it + 1) / C::NBUF) & 1);\n",
       "      mbar_wait(full + bv, ((it + 1) / C::NBUF) & 1);\n"
       "      TICK(7);\n")
    at("      if (gl == 0) mbar_arrive(empty + bv);\n",
       "      if (gl == 0) mbar_arrive(empty + bv);\n      TICK(8);\n")
    at("    if (part > 0) continue;\n",
       "    if (part > 0) { TICK(9); continue; }\n")
    at("                         &y[C::OW * c]);\n    }\n  }\n}\n",
       "                         &y[C::OW * c]);\n    }\n    TICK(9);\n  }\n"
       "  unsigned long long g_end;\n"
       '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_end));\n'
       f"  ph[{n}] = g_end - g_start;\n  ph[{n + 1}] = clock64() - c_start;\n"
       f"  if (gl == 0)\n    for (int k = 0; k < {n + 2}; ++k) "
       "atomicAdd(&g_clk[k], ph[k]);\n}\n")
    at('extern "C" const char* flash_attention_error_string',
       'extern "C" void flash_phase_clocks(unsigned long long* out, '
       'int reset) {\n  unsigned long long z[sizeof(g_clk) / 8] = {0};\n'
       "  if (reset) cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n"
       "  else cudaMemcpyFromSymbol(out, g_clk, sizeof(z));\n}\n\n"
       'extern "C" const char* flash_attention_error_string')
    return src


def build(name: str, src: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    cu, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(cu)], capture_output=True,
                          text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed on {cu}:\n{done.stdout}{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.flash_attention_f32.restype = ctypes.c_int
    dll.flash_attention_f32.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_float, ctypes.c_void_p])
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels.ref import attention_ref
    chip_smoke.card()   # the card's name and power limit; TF32 off
    OUT.mkdir(parents=True, exist_ok=True)
    source = SRC.read_text()
    libs = {"kernel": build("plain", source),
            "instrumented": build("clocks", instrumented(source))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for name, bh, s, t, causal in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(5)
        q = torch.randn(bh, s, 64, generator=g, device="cuda")
        k, v = (torch.randn(bh, t, 64, generator=g, device="cuda")
                for _ in range(2))
        ref = attention_ref(q, k, v, causal=causal)
        line = [f"[phases] {name} ({bh} heads, S={s}, T={t}, D=64, "
                f"causal={causal})"]
        for tag, lib in libs.items():
            o = torch.empty_like(q)

            def call():
                err = lib.flash_attention_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None, bh, bh, s, t, 64, int(causal), 0, 0.0, stream)
                if err:
                    raise SystemExit(f"launch failed: {err}")
            ms = chip_smoke.cuda_ms(call)
            err = (o - ref).abs().max().item()
            if err > ATOL:
                raise SystemExit(f"{tag} at {name}: max err {err:.3e}")
            line.append(f"{tag} {ms:.4f} ms (max abs err {err:.2e})")
            if tag == "instrumented":
                n = len(PHASES)
                clk = (ctypes.c_ulonglong * (n + 2))()
                lib.flash_phase_clocks(clk, 1)
                call()
                torch.cuda.synchronize()
                lib.flash_phase_clocks(clk, 0)
                total = sum(clk[:n])
                line.append("; ".join(f"{p} {clk[i] / total:.3f}"
                                      for i, p in enumerate(PHASES)))
                line.append(f"SM clock {clk[n + 1] / clk[n]:.3f} GHz; "
                            f"consumer warps in the kernel "
                            f"{clk[n] / (sms * 8 * ms * 1e6):.3f} of the "
                            f"event time")
        print("; ".join(line[:1] + line[1:3]) + "\n  " + "\n  ".join(
            line[3:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
