"""Builds the port's CUDA kernels at first use and loads them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library for Hopper
(``sm_90a``) with a plain ``extern "C"`` interface: no PyTorch headers, so a
build takes seconds.  The library lands in ``build/kernels/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited source
is never served from a stale build.  Nothing here runs at import.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# name -> (restype, argtypes) of every function the library exports
SIGNATURES = {
    "fused_conv_f32": (_int, [_ptr] * 6 + [_int] * 12 + [_ptr]),
    "fused_conv_error_string": (ctypes.c_char_p, [_int]),
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
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"repro_torch_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
