"""Builds the port's CUDA kernels at first use and loads them with ctypes.

``nvcc`` compiles each ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain ``extern "C"`` interface: no PyTorch headers, so a
build takes seconds.  The library lands in ``build/kernels/`` at the root of
the checkout, named by a hash of the sources, the headers beside them
(``csrc/*.cuh``) and the flags, so an edited source is never served from a
stale build.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# name -> (restype, argtypes) of every function the library exports
SIGNATURES = {
    "fused_conv_sm90_f32": (_int, [_ptr] * 6 + [_int] * 15 + [_ptr]),
    "fused_conv_sm90_bf16": (_int, [_ptr] * 6 + [_int] * 15 + [_ptr]),
    "fused_conv_sm90_error_string": (ctypes.c_char_p, [_int]),
    "fused_conv_sm90_smem_bytes": (_int, [_int, _int]),
    "fused_conv_sm90_resident_blocks": (_int, [_int, _int]),
    "flash_attention_f32": (_int, [_ptr] * 5 + [_int] * 7
                            + [ctypes.c_float, _ptr]),
    "flash_attention_f32_smem_bytes": (_int, [_int]),
    "flash_attention_error_string": (ctypes.c_char_p, [_int]),
    "flash_attention_sm90_bf16": (_int, [_ptr] * 6 + [_int] * 7
                                  + [ctypes.c_float, _ptr]),
    "flash_attention_bwd_f32": (_int, [_ptr] * 12 + [_int] * 7
                                + [ctypes.c_float, _ptr]),
    "flash_attention_bwd_f32_smem_bytes": (_int, [_int]),
    "flash_attention_bwd_sm90_bf16": (_int, [_ptr] * 15 + [_int] * 7
                                      + [ctypes.c_float, _ptr]),
    "flash_attention_bwd_sm90_smem_bytes": (_int, [_int]),
    "flash_attention_sm90_error_string": (ctypes.c_char_p, [_int]),
    "flash_attention_sm90_smem_bytes": (_int, [_int]),
    "mamba_scan_sm90_f32": (_int, [_ptr] * 6 + [_int] * 9 + [_ptr]),
    "mamba_scan_sm90_error_string": (ctypes.c_char_p, [_int]),
    "mamba_scan_sm90_resident_blocks": (_int, [_int, _int]),
    "mamba_scan_sm90_smem_bytes": (_int, [_int, _int]),
    "mlstm_scan_sm90_f32": (_int, [_ptr] * 7 + [_int] * 5 + [_ptr]),
    "mlstm_scan_sm90_error_string": (ctypes.c_char_p, [_int]),
    "mlstm_scan_sm90_scratch_bytes": (ctypes.c_longlong, [_int] * 5),
    "mlstm_scan_sm90_smem_bytes": (_int, [_int, _int]),
    "mamba_scan_bwd_sm90_f32": (_int, [_ptr] * 10 + [_int] * 7 + [_ptr]),
    "mamba_scan_bwd_sm90_scratch_bytes": (ctypes.c_longlong, [_int] * 4),
    "mamba_scan_bwd_sm90_smem_bytes": (_int, [_int]),
    "mamba_scan_bwd_sm90_resident_blocks": (_int, [_int]),
    "mlstm_scan_bwd_sm90_f32": (_int, [_ptr] * 13 + [_int] * 4 + [_ptr]),
    "mlstm_scan_bwd_sm90_scratch_bytes": (ctypes.c_longlong, [_int] * 3),
    "mlstm_scan_bwd_sm90_smem_bytes": (_int, [_int]),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the port's "
                           "kernels are compiled with nvcc at first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Compiles the kernels unless a build of these exact sources exists;
    returns the library's path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it as ``.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the sources and their headers
        digest.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"repro_torch_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    reports = [proc.communicate()[0] for proc in procs]
    for src, proc, report in zip(sources, procs, reports):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({proc.returncode}):\n{report}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stderr}")
    lib.with_suffix(".log").write_text("".join(reports))
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(library_path()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
