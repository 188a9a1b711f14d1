"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout, holds the
kernel variant each of the main path's shapes launches against its plain
PyTorch version, times it beside its bound, checks the README
anchors, then drives the main path at full size: vapor pressures of a
100,000-row ``make_batch`` with reverse-mode gradients with respect to all 8
parameters of every row.  Every phase raises on failure.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches on the main path, its error against the plain version, its
times and its bound.  Without CUDA the script exits nonzero and prints no
result.
"""

import json
import re
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
# NVIDIA H100 SXM data sheet: f64 outside the tensor cores, and HBM3
PEAK_F64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12
# f64 operations (+, -, *, /, fmin) phi_d2 needs: the row stage once a row,
# the density stage at every element, the dipole term only on rows with
# mu != 0 and the association term only on rows with kappa_ab (exp(eps_ab/T)
# - 1) != 0, shorter where na = nb.  They are the tally of
# feos_tpu_torch/csrc/pcsaft_pure_d3.cuh by csrc/phi_d2_ops.cpp, without the
# operations on known zeros; tests/test_torch_phi_d2.py holds the header to
# them, so that added arithmetic cannot raise the bound.
OPS_ROW = 146
OPS_ELEMENT = 321
OPS_DIPOLE = 94
OPS_ASSOC = 165
OPS_ASSOC_SYMMETRIC = 93
# bytes phi_d2 must move: 8 parameters and T a row; rho in and three
# outputs an element
BYTES_ROW = 72
BYTES_ELEMENT = 32
REPS = 50
# f64 SASS opcodes; MUFU.RCP64H and MUFU.RSQ64H seed divisions and sqrt
F64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "MUFU.RCP64H", "MUFU.RSQ64H")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def f64(x, dev):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)


def cuda_ms(fn, reps=REPS):
    """Mean device time of ``fn`` in ms over ``reps`` calls, from CUDA
    events, after one warm-up call.  A sleep kernel holds the stream while
    the host queues the calls, so the events time the device and not the
    host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
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


# Straight-line probes of the header's parts, compiled on their own so that
# the f64 instructions an element runs can be read off their SASS.
PROBES = r"""
#include "pcsaft_pure_d3.cuh"
using namespace feos;
__device__ void out3(double* o, D3 v) { o[0] = v.re; o[1] = v.v1; o[2] = v.v2; }
extern "C" __global__ void probe_row(const double* par, RowConsts* rc) {
    *rc = row_consts(par, par[8]);
}
extern "C" __global__ void probe_base(const RowConsts* rc, const double* rho, double* o) {
    const Powers p = powers(*rc, *rho);
    out3(o, phi_hs_hc(*rc, p) + phi_disp(*rc, p));
}
extern "C" __global__ void probe_dipole(const RowConsts* rc, const double* rho, double* o) {
    const Powers p = powers(*rc, *rho);
    out3(o, phi_hs_hc(*rc, p) + phi_disp(*rc, p) + phi_dipole(*rc, p));
}
// the na = nb path, which every associating make_batch row takes
extern "C" __global__ void probe_assoc(const RowConsts* rc, const double* rho, double* o) {
    const Powers p = powers(*rc, *rho);
    const D3 rhoa = {rc->na * *rho, rc->na, 0.0};
    out3(o, phi_hs_hc(*rc, p) + phi_disp(*rc, p) + assoc_symmetric(rhoa, assoc_delta(*rc, p)));
}
"""


def sass_f64(binary):
    """``{function: (instructions, f64 instructions, f64 instructions up to
    the first unpredicated EXIT)}`` from ``cuobjdump -sass``.  Code past
    that EXIT is the rarely taken slow paths of divisions and logs."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(binary)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name, open_ = {}, None, False
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, open_ = m.group(1), True
            counts[name] = [0, 0, 0]
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            is_f64 = m.group(2).startswith(F64_OPCODES)
            counts[name][0] += 1
            counts[name][1] += is_f64
            counts[name][2] += is_f64 and open_
            open_ = open_ and not (m.group(2) == "EXIT" and not m.group(1))
    return counts


def probe_f64(out_dir):
    """f64 instructions the header's parts run: the row stage, and at one
    density the base terms, the dipole and the na = nb association."""
    src = out_dir / "probes.cu"
    src.write_text(PROBES)
    cubin = out_dir / "probes.cubin"
    subprocess.run([build._nvcc(), "-cubin", *build.ARCH_FLAGS,
                    f"-I{build.CSRC}", "-o", str(cubin), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    runs = {name: c[2] for name, c in sass_f64(cubin).items()}
    return {"row": runs["probe_row"], "base": runs["probe_base"],
            "dipole": runs["probe_dipole"] - runs["probe_base"],
            "assoc": runs["probe_assoc"] - runs["probe_base"]}


def kernel_name(mangled):
    """``phi_d2_elem`` from a mangled kernel name."""
    m = re.search(r"\d(phi_d2_[a-z]+)", mangled)
    return m.group(1) if m else mangled


def variant(k):
    """The kernel variant ``feos_phi_d2`` launches at k densities a row."""
    return "tile" if k >= 3 else ("row" if k == 2 else "elem")


def empty_launch(rho):
    """A kernel that does nothing, on the grid ``phi_d2`` launches for rho."""
    err = build.library().feos_phi_d2_empty(
        rho.shape[0], rho.shape[1], rho.device.index,
        torch.cuda.current_stream(rho.device).cuda_stream)
    check(err == 0, f"empty launch failed: cudaError {err}")


def main_shapes(dev, params, temperature):
    """The solver's three density shapes on these rows: the Newton and
    liquid NPT lanes (liquid- and vapour-like packing fractions), the vapour
    NPT lane, the spinodal grid."""
    eta_m = precompute_pure(PureParams.from_tensor(params), temperature).eta_m
    return {
        "(B, 2)": torch.stack([0.45 / eta_m, 1e-3 / eta_m], 1).contiguous(),
        "(B, 1)": (1e-3 / eta_m)[:, None].contiguous(),
        "(B, 48)": (f64(_ETA_GRID, dev)[None, :] / eta_m[:, None]).contiguous(),
    }


@torch.no_grad()
def work(params, temperature, k):
    """``(ops, bytes)`` that ``phi_d2`` must do and move for ``params
    (B, 8)`` and ``temperature (B,)`` at ``k`` densities a row: the
    operation counts above on these rows' terms, each input read once and
    each output written once."""
    pre = precompute_pure(PureParams.from_tensor(params), temperature)
    B = params.shape[0]
    dipolar = int((pre.mu2eff != 0.0).sum())
    associating = pre.delta_t != 0.0
    symmetric = int((associating & (pre.na == pre.nb)).sum())
    ops = B * OPS_ROW + k * (B * OPS_ELEMENT + dipolar * OPS_DIPOLE
                             + (int(associating.sum()) - symmetric) * OPS_ASSOC
                             + symmetric * OPS_ASSOC_SYMMETRIC)
    return ops, B * BYTES_ROW + B * k * BYTES_ELEMENT


def bound(params, temperature, k):
    """``(bound_ms, bound_by)``: the larger of the f64 operations over the
    f64 peak and the bytes over the memory rate, for these rows at k."""
    ops, nbytes = work(params, temperature, k)
    t_ops, t_bytes = ops / PEAK_F64_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_vs_plain(dev, params, temperature):
    """Phase 3: at each of the main path's shapes, the variant it launches
    against the plain version, timed beside its bound and an empty launch
    of its grid; the golden values."""
    result = {"max_abs_err": 0.0, "shapes": {}}
    for name, rho in main_shapes(dev, params, temperature).items():
        k = rho.shape[1]
        want = phi_d2_plain(params, temperature, rho)
        got = phi_d2(params, temperature, rho)
        torch.cuda.synchronize()
        errs = [max_scaled_error(a, b) for a, b in zip(got, want)]
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        print(f"kernel {variant(k)} vs plain {name}: scaled err phi {errs[0]:.3e}, "
              f"phi' {errs[1]:.3e}, phi'' {errs[2]:.3e} (bound {KERNEL_BOUND:g}), "
              f"max abs err {abs_err:.3e}")
        check(max(errs) < KERNEL_BOUND, f"phi_d2 {variant(k)} at {name} off its plain version")
        result["max_abs_err"] = max(result["max_abs_err"], abs_err)
        # in turns: plain, kernel, kernel, plain
        plain_1 = cuda_ms(lambda: phi_d2_plain(params, temperature, rho), 3)
        kern_1 = cuda_ms(lambda: phi_d2(params, temperature, rho))
        kern_2 = cuda_ms(lambda: phi_d2(params, temperature, rho))
        plain_2 = cuda_ms(lambda: phi_d2_plain(params, temperature, rho), 3)
        empty = cuda_ms(lambda: empty_launch(rho))
        kern, plain = (kern_1 + kern_2) / 2, (plain_1 + plain_2) / 2
        bound_ms, bound_by = bound(params, temperature, k)
        print(f"phi_d2 {name}: variant {variant(k)}, scaled err {max(errs):.3e}, "
              f"kernel {kern:.5f} ms ({kern_1:.5f}, {kern_2:.5f}), plain {plain:.3f} ms "
              f"({plain_1:.3f}, {plain_2:.3f}), bound {bound_ms:.5f} ms ({bound_by}), "
              f"share of bound {bound_ms / kern:.3f}, empty launch {empty:.5f} ms")
        result["shapes"][name] = {
            "variant": variant(k), "ms": kern, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / kern,
            "empty_ms": empty, "max_scaled_err": max(errs),
        }

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
    """Phase 5: the full-size main path, with the launch counts and rate."""
    stats = {}
    pure_vle(params, temperature, stats=stats)  # warm-up; loop iteration counts
    torch.cuda.synchronize()
    print(f"solver loops at B={B}: {stats}")

    phi_d2.launches = 0
    phi_d2.launches_by_k = {}
    nans, grad = solves_and_grads(params, temperature)
    torch.cuda.synchronize()
    launches, by_k = phi_d2.launches, dict(phi_d2.launches_by_k)
    n_ok = int((~nans).sum())
    print(f"converged {n_ok} of {B} ({100.0 * n_ok / B:.4f}%), phi_d2 launches {launches}, "
          f"by k {by_k}")
    check(n_ok >= MIN_CONVERGED, f"only {n_ok} of {B} rows converged")
    check(bool(torch.isfinite(grad).all()), "non-finite parameter gradients")
    check(launches >= stats["phi_d2_calls"] > 0,
          f"{launches} phi_d2 launches for {stats['phi_d2_calls']} solver evaluations")
    check(sorted(by_k) == [1, 2, 48] and sum(by_k.values()) == launches,
          f"phi_d2 launches by k {by_k}")

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
    return launches, by_k


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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  nvcc: {line.strip()}")
    build.library()
    for mangled, (total, f64_all, f64_run) in sass_f64(built["path"]).items():
        print(f"  sass {kernel_name(mangled)}: {total} instructions, {f64_all} f64, "
              f"{f64_run} f64 up to its first exit")
    probes = probe_f64(built["path"].parent)
    print(f"  f64 instructions run: row stage {probes['row']}, at each density "
          f"{probes['base']} (hard sphere, chain, dispersion) + {probes['dipole']} "
          f"(dipole) + {probes['assoc']} (association, na = nb)")

    params_np, temperature_np = make_batch(B, seed=0)
    params, temperature = f64(params_np, dev), f64(temperature_np, dev)
    kernel = kernel_vs_plain(dev, params, temperature)
    readme_anchors(dev)
    launches, by_k = main_path(dev, params, temperature, power)

    shapes = kernel["shapes"]
    ref = shapes["(B, 2)"]  # the most launched shape, with (B, 1)
    print(json.dumps({"kernels": [{
        "name": "phi_d2",
        "route": "cuda",
        "source": "feos_tpu_torch/csrc/phi_d2.cu",
        "replaces": "benchmarks/pallas_experiment.py:158",
        "launches": launches,
        "launches_by_k": {str(k): n for k, n in sorted(by_k.items())},
        "max_abs_err": kernel["max_abs_err"],
        "ms": ref["ms"],
        "plain_ms": ref["plain_ms"],
        "bound_ms": ref["bound_ms"],
        "bound_by": ref["bound_by"],
        "library_ms": None,  # no single PyTorch call computes phi, phi', phi''
        "shapes": shapes,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
