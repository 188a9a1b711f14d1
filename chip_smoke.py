"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version at the main path's shapes, checks the
README anchors, then drives the main path at full size: vapor pressures of a
100,000-row ``make_batch`` with reverse-mode gradients with respect to all 8
parameters of every row.  Every phase raises on failure.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launch count on the main path, its error against the plain version and
both times.  Without CUDA the script exits nonzero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from feos_tpu_torch import make_batch, pure_vle, vapor_pressure
from feos_tpu_torch.kernels import build
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error, phi_d2, phi_d2_plain
from feos_tpu_torch.models.pcsaft_pure import PureParams, precompute_pure
from feos_tpu_torch.solvers.vle import _ETA_GRID

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "pure_helmholtz.json"
B = 100_000
MIN_CONVERGED = 99_990
KERNEL_BOUND = 1e-11     # max_scaled_error of phi, phi', phi'' vs the plain version
GOLDEN_ATOL = 1e-14      # tests/test_pcsaft_pure.py::test_helmholtz_derivatives_golden
README_PARAMS = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]
README_T = [250.0, 300.0, 350.0, 400.0, 450.0]
README_VP = [20693.5960, 216164.6184, 1049770.6187, 3281855.9640, 7875531.7021]
README_VP_RTOL = 5e-9
README_GRAD = [-6.7923e4, -1.7737e4, -7.0413e2, 0.0, -5.7458e5, -6.9122e1,
               -3.6892e4, -3.6892e4]
README_GRAD_RTOL = 5e-4


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def f64(x, dev):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_vs_plain(dev, params, temperature):
    """Phase 3: the kernel against its plain version at the main path's
    shapes, and against the golden values."""
    eta_m = precompute_pure(PureParams.from_tensor(params), temperature).eta_m
    # the solver's shapes: Newton and liquid NPT lanes (liquid- and
    # vapour-like packing fractions), the vapour NPT lane, the spinodal grid
    shapes = {
        "(B, 2)": torch.stack([0.45 / eta_m, 1e-3 / eta_m], 1),
        "(B, 1)": (1e-3 / eta_m)[:, None],
        "(B, 48)": f64(_ETA_GRID, dev)[None, :] / eta_m[:, None],
    }
    result = {"max_abs_err": 0.0}
    for name, rho in shapes.items():
        rho = rho.contiguous()
        got = phi_d2(params, temperature, rho)
        want = phi_d2_plain(params, temperature, rho)
        torch.cuda.synchronize()
        for label, a, b in zip(("phi", "phi'", "phi''"), got, want):
            err = max_scaled_error(a, b)
            abs_err = float((a - b).abs().max())
            result["max_abs_err"] = max(result["max_abs_err"], abs_err)
            print(f"kernel vs plain {name} {label}: scaled err {err:.3e} "
                  f"(bound {KERNEL_BOUND:g}), max abs err {abs_err:.3e}")
            check(err < KERNEL_BOUND, f"phi_d2 {label} at {name} off its plain version")
        # in turns: plain, kernel, kernel, plain
        plain_1 = cuda_ms(lambda: phi_d2_plain(params, temperature, rho), 3)
        kern_1 = cuda_ms(lambda: phi_d2(params, temperature, rho), 20)
        kern_2 = cuda_ms(lambda: phi_d2(params, temperature, rho), 20)
        plain_2 = cuda_ms(lambda: phi_d2_plain(params, temperature, rho), 3)
        kern, plain = (kern_1 + kern_2) / 2, (plain_1 + plain_2) / 2
        print(f"phi_d2 {name}: kernel {kern:.4f} ms ({kern_1:.4f}, {kern_2:.4f}), "
              f"plain {plain:.4f} ms ({plain_1:.4f}, {plain_2:.4f})")
        result[name] = (kern, plain)

    gold = json.loads(GOLDEN.read_text())
    n = len(gold["params"])
    rho0 = gold["density"]
    phi, d1, d2 = (x[:, 0].cpu().numpy() for x in phi_d2(
        f64(gold["params"], dev), f64(np.full(n, gold["temperature"]), dev),
        f64(np.full((n, 1), rho0), dev),
    ))
    for label, got, want in (
        ("phi", phi, gold["a"]),
        ("p~", rho0 - phi + rho0 * d1, gold["p"]),
        ("dp~/drho", 1.0 + rho0 * d2, gold["dp"]),
    ):
        err = float(np.max(np.abs(got - np.asarray(want))))
        print(f"kernel vs golden {label}: max abs err {err:.3e} (atol {GOLDEN_ATOL:g})")
        check(err <= GOLDEN_ATOL, f"phi_d2 {label} off the golden values")
    return result


def readme_anchors(dev):
    """Phase 4: README vapor pressures and gradient through the port."""
    p0 = f64(README_PARAMS, dev).requires_grad_()
    nans, vp = vapor_pressure(p0.expand(len(README_T), 8), f64(README_T, dev))
    check(not bool(nans.any()), "README rows failed")
    vp[0].backward()
    got = vp.detach().cpu().numpy()
    rel = np.max(np.abs(got / np.asarray(README_VP) - 1.0))
    print(f"README vapor pressures {got.tolist()} Pa: max rel err {rel:.3e} "
          f"(rtol {README_VP_RTOL:g})")
    check(rel < README_VP_RTOL, "README vapor pressures")
    grad = p0.grad.cpu().numpy()
    want = np.asarray(README_GRAD)
    print(f"README d vp[0] / d params {grad.tolist()}")
    check(np.all(np.abs(grad - want) <= README_GRAD_RTOL * np.abs(want)), "README gradient")


def solves_and_grads(params, temperature):
    """The main path: vapor pressures, then d/dparams of sum log p over the
    converged rows (bench.py's loss)."""
    p = params.detach().requires_grad_()
    nans, vp = vapor_pressure(p, temperature)
    loss = torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, vp))).sum()
    loss.backward()
    return nans, p.grad


def main_path(dev, params, temperature, power):
    """Phase 5: the full-size main path, with the launch count and rate."""
    stats = {}
    pure_vle(params, temperature, stats=stats)  # warm-up; loop iteration counts
    torch.cuda.synchronize()
    print(f"solver loops at B={B}: {stats}")

    phi_d2.launches = 0
    nans, grad = solves_and_grads(params, temperature)
    torch.cuda.synchronize()
    launches = phi_d2.launches
    n_ok = int((~nans).sum())
    print(f"converged {n_ok} of {B} ({100.0 * n_ok / B:.4f}%), phi_d2 launches {launches}")
    check(n_ok >= MIN_CONVERGED, f"only {n_ok} of {B} rows converged")
    check(bool(torch.isfinite(grad).all()), "non-finite parameter gradients")
    check(launches >= stats["phi_d2_calls"] > 0,
          f"{launches} phi_d2 launches for {stats['phi_d2_calls']} solver evaluations")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solves_and_grads(params, temperature)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = statistics.median(times)
    print(f"main path B={B}: step {step * 1e3:.1f} ms (median of "
          f"{[round(t * 1e3, 1) for t in times]} ms), "
          f"{n_ok / step:.1f} converged solves+gradients/s on {power}")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one card")
    dev = torch.device("cuda", 0)
    power = card()
    print(power)  # the card's name and power limit, as nvidia-smi gives them
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    built = build.build()
    print(f"kernel build: {built['seconds']:.1f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            print(f"  nvcc: {line.strip()}")
    build.library()

    params_np, temperature_np = make_batch(B, seed=0)
    params, temperature = f64(params_np, dev), f64(temperature_np, dev)
    kernel = kernel_vs_plain(dev, params, temperature)
    readme_anchors(dev)
    launches = main_path(dev, params, temperature, power)

    kern_ms, plain_ms = kernel["(B, 2)"]
    print(json.dumps({"kernels": [{
        "name": "phi_d2",
        "route": "cuda",
        "source": "feos_tpu_torch/csrc/phi_d2.cu",
        "replaces": "benchmarks/pallas_experiment.py:158",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
