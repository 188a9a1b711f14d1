"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``*.cu`` under ``feos_tpu_torch/csrc/`` into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds).  The library lands in ``build/feos_tpu_torch/<hash>/`` beside
the package, keyed by a hash of the sources and the flags, so an edited
source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "feos_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
NVCC_FLAGS = [*ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC", "--resource-usage"]
LIB_NAME = "libfeos_kernels.so"

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels unless this source hash is built already.

    Returns ``{"path", "seconds", "log"}``: ``seconds`` is 0 for a reused
    build, and ``log`` holds nvcc's ``--resource-usage`` report (registers,
    spills) of the build that made the library.
    """
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        return {"path": lib_path, "seconds": 0.0, "log": log_path.read_text()}
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a library
    return {"path": lib_path, "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()["path"]))
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        i32 = ctypes.c_int
        lib.feos_phi_d2.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
        lib.feos_phi_d2.restype = i32
        lib.feos_phi_d2_empty.argtypes = [i64, i64, i32, ptr]
        lib.feos_phi_d2_empty.restype = i32
        _lib = lib
    return _lib
