"""Time other versions of the phi_d2 kernel against this checkout's, in turns.

Each DIR holds a version of ``feos_tpu_torch/csrc`` (its ``*.cu`` sources and
the headers they include) whose library exports ``feos_phi_d2`` with this
checkout's C signature: an earlier commit's sources, or a copy of the current
ones edited to launch another variant.  Run from the repository root on a
machine with one CUDA card:

    python3 phi_d2_turns.py LABEL=DIR [LABEL=DIR ...]

Each version is built with this checkout's nvcc flags into
``build/phi_d2_turns/LABEL/`` (its registers and spills printed) and held
against the plain version at the main path's shapes: ``make_batch(100000,
seed=0)`` at the densities ``chip_smoke.py`` uses.  At each shape the
versions and this checkout's kernel are timed with ``chip_smoke.cuda_ms`` in
turns, in the order given and then in reverse (old, new, new, old for one
DIR), and the SM clock is read while this checkout's kernel runs back to back.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from feos_tpu_torch import make_batch
from feos_tpu_torch.kernels import build
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error, phi_d2, phi_d2_plain


def load(label, src):
    """Build the sources in ``src`` and load their ``feos_phi_d2``."""
    out_dir = build.BUILD_ROOT.parent / "phi_d2_turns" / label
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / build.LIB_NAME
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{src}", "-o", str(lib_path),
         *map(str, sorted(src.glob("*.cu")))],
        capture_output=True, text=True, timeout=600,
    )
    log = proc.stdout + proc.stderr
    cs.check(proc.returncode == 0, f"nvcc failed on {src}:\n{log}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  {label} nvcc: {line.strip()}")
    lib = ctypes.CDLL(str(lib_path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.feos_phi_d2.argtypes = [ptr, ptr, ptr, ptr, i64, i64, ctypes.c_int, ptr]
    lib.feos_phi_d2.restype = ctypes.c_int
    return lib


def launcher(lib, params, temperature, rho):
    def run():
        out = torch.empty((3,) + tuple(rho.shape), dtype=torch.float64, device=rho.device)
        err = lib.feos_phi_d2(params.data_ptr(), temperature.data_ptr(), rho.data_ptr(),
                              out.data_ptr(), rho.shape[0], rho.shape[1], rho.device.index,
                              torch.cuda.current_stream(rho.device).cuda_stream)
        cs.check(err == 0, f"launch failed: cudaError {err}")
        return out
    return run


def main():
    versions = [arg.split("=", 1) for arg in sys.argv[1:]]
    if not versions or any(len(v) != 2 for v in versions):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("phi_d2_turns: CUDA is not available; this script needs one card")
    dev = torch.device("cuda", 0)
    power = cs.card()
    print(power)
    libs = {label: load(label, Path(src).resolve()) for label, src in versions}
    params_np, temperature_np = make_batch(cs.B, seed=0)
    params, temperature = cs.f64(params_np, dev), cs.f64(temperature_np, dev)

    for name, rho in cs.main_shapes(dev, params, temperature).items():
        want = phi_d2_plain(params, temperature, rho)
        runs = {label: launcher(lib, params, temperature, rho) for label, lib in libs.items()}
        runs["checkout"] = lambda: phi_d2(params, temperature, rho)
        for label, run in runs.items():
            err = max(max_scaled_error(a, b) for a, b in zip(run(), want))
            print(f"turns {name}: {label} vs plain scaled err {err:.3e}")
            cs.check(err < cs.KERNEL_BOUND, f"{label} at {name} off the plain version")
        times = {label: [] for label in runs}
        for order in (list(runs), list(runs)[::-1]):
            for label in order:
                times[label].append(cs.cuda_ms(runs[label]))
        ours = sum(times["checkout"])
        for label, (t1, t2) in times.items():
            print(f"turns {name}: {label} {t1:.5f} {t2:.5f} ms, "
                  f"{(t1 + t2) / ours:.3f}x the checkout's time")
        # the SM clock while the card runs this shape's kernel back to back
        torch.cuda._sleep(50_000_000)
        for _ in range(int(300.0 / times["checkout"][0])):
            phi_d2(params, temperature, rho)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout
        torch.cuda.synchronize()
        print(f"turns {name}: under load, SM clock, max SM clock, power: {clocks.strip()} "
              f"({power})")


if __name__ == "__main__":
    main()
