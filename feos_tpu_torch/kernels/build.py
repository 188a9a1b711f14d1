"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``*.cu`` under ``feos_tpu_torch/csrc/`` into an
object, one process a source, all started together, and links the objects
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds).  The library lands in ``build/feos_tpu_torch/<hash>/``
beside the package, keyed by a hash of the sources and the flags, so an
edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .. import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "feos_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
NVCC_FLAGS = [*ARCH_FLAGS, "-Xcompiler", "-fPIC", "--resource-usage"]
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
    pid = os.getpid()
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o",
               str(out_dir / f"{src.stem}.{pid}.o"), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log = ""
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log += out
        if proc.returncode != 0:
            for _, other in procs:
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    objects = [cmd[cmd.index("-o") + 1] for cmd, _ in procs]
    cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *objects]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objects:
        os.remove(obj)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a library
    return {"path": lib_path, "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be; the call that
    builds or loads it is the tracer's span ``feos.setup.library``."""
    global _lib
    if _lib is None:
        with tracing.span("setup.library"):
            _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["path"]))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    i32 = ctypes.c_int
    lib.feos_phi_d2.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
    lib.feos_phi_d2.restype = i32
    lib.feos_phi_d2_empty.argtypes = [i64, i64, i32, ptr]
    lib.feos_phi_d2_empty.restype = i32
    lib.feos_pure_vle.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, ptr]
    lib.feos_pure_vle.restype = i32
    lib.feos_vp_identity.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, ptr]
    lib.feos_vp_identity.restype = i32
    for name in ("feos_pure_vle_occupancy", "feos_vp_identity_occupancy"):
        getattr(lib, name).argtypes = [i32, ptr]
        getattr(lib, name).restype = i32
    return lib
