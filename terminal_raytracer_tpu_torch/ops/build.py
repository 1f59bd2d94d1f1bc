"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile at first use with nvcc into one shared library with a
plain C interface, loaded with ctypes: no PyTorch headers, so a build
takes seconds, not minutes. The library is content-hashed over the sources
and flags and kept in ``terminal_raytracer_tpu_torch/_build/`` (listed in
.gitignore); nvcc's output, including ``-Xptxas -v`` register and spill
counts, is kept beside it as ``<name>.log``.

``--fmad=false`` keeps nvcc from contracting a*b+c into one fused
multiply-add, so each kernel rounds like its plain PyTorch version; fast
math is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("kernel_base.cu", "kernel_extra.cu")
HEADERS = ("trace.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then PATH, then /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Build the library if needed; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode() + (CSRC / name).read_bytes())
    so = BUILD_DIR / f"trt_kernels-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        p = ctypes.c_void_p
        lib.trt_kernel_base.restype = ctypes.c_int
        lib.trt_kernel_base.argtypes = [p, p, p, p, p, p]
        lib.trt_kernel_extra.restype = ctypes.c_int
        lib.trt_kernel_extra.argtypes = [p] * 10
        _lib = lib
    return _lib
