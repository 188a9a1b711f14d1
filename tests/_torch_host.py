"""Host builds of the port's CUDA kernels' arithmetic, for the CPU tests.

Each kernel's per-row arithmetic lives in a header under
``feos_tpu_torch/csrc/`` that ``g++`` builds as well as ``nvcc``; a
``*_host.cpp`` shim loops it over a batch behind a C interface, which the
tests load with ctypes.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parent.parent / "feos_tpu_torch" / "csrc"


def gxx_build(tmp_path_factory, source):
    """``csrc/<source>`` built with ``g++`` into a shared library, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    lib_path = tmp_path_factory.mktemp("host") / f"lib{Path(source).stem}.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(lib_path), str(CSRC / source)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib_path))


def ptr(a):
    """The data pointer of a contiguous numpy array, for ctypes."""
    return ctypes.c_void_p(a.ctypes.data)
