"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout, holds the
kernel variant each of the main path's shapes launches against its plain
PyTorch version, times it beside its bound, checks the README
anchors, then drives the main path at full size: vapor pressures of a
100,000-row ``make_batch`` with reverse-mode gradients with respect to all 8
parameters of every row (phase 5).  Phases 6-10 drive the rest of the
pure-component surface on the same rows, each with its phi_d2 launches by k:
liquid and saturated liquid densities, critical points, boiling
temperatures (each with a parameter gradient), residual properties, and
three steps of ``fit_pure``; each reruns its first 2,000 rows on the CPU
through the plain path and holds the card to it (the fit runs 2,000 rows on
both).  Phases 11-12 drive binary-mixture PC-SAFT, which launches no kernel
(its phi evaluations are torch ops): the derivative set (A, p~, mu, v) of
the 14 golden regimes, and bubble and dew pressures of config 3 of
``benchmarks/run_all.py`` (a cross-associating pair with kij and eps_AiBj)
at 4,096 and 100,000 rows and of a non-associating pair at 4,096, each with
the gradient of sum log p in the parameters and kij, a warm-started rerun,
and its first 512 rows rerun on the CPU.  Phase 13 drives heterosegmented
gc-PC-SAFT, which launches no kernel either: the derivative set of the 11
golden topologies (also tiled to 100,000 rows), bubble and dew pressures of
config 4 of ``benchmarks/run_all.py`` (butane/propane with k_ab and phi)
at 4,096 and 100,000 rows and of the golden topologies (every association
regime) at 4,096, each with the gradient of sum log p in the segment
parameters, k_ab and phi, a warm start and 512 rows on the CPU, and three
``fit_gc`` steps.  Phase 14 drives the binary workload built on bubble and
dew points, torch ops but for the diagrams' pure seeds (``phi_d2``): bubble
and dew temperatures of config 3 and of config 4 at 4,096 and 100,000 rows
(the golden topologies at 512) at the port's own pressures, with gradients,
the implicit-function identity and 512 rows on the CPU; three
``fit_binary`` steps; p-x-y and T-x-y diagrams with the closure of their
dew curves; and the residual properties of config 3's and config 4's
100,000 coexisting phases, with isofugacity and 2,000 rows on the CPU.
Phase 15 drives the isothermal pT flash, torch ops only: config 6 of
``benchmarks/run_all.py`` (config 3's pair at the log-midpoint of its
bubble and dew pressures) at 4,096 and 100,000 rows, timed as run_all.py
times it, with material balance, isobaric closure and isofugacity through
``mix_properties`` and 512 rows on the CPU; the same with gradients at
4,096 rows, held to the phase rule (dbeta/dz1 = 1/(y1 - x1), dx/dz1 = 0)
and to the CPU; gc config 4 at 4,096 rows without and with gradients; and
the profile of the 100,000-row call.  Every phase raises on failure.

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
from functools import partial
from pathlib import Path

import numpy as np
import torch

from feos_tpu_torch import (
    GcPcSaftMix, PureParams, ResidualProperties, binary_pxy, binary_txy, boiling_temperature,
    bubble_point, bubble_point_t, critical_point, dew_point, dew_point_t,
    equilibrium_liquid_density, fit_binary, fit_gc, fit_pure, flash, gc_binary_pxy,
    gc_binary_txy, gc_helmholtz_energy_density, gc_properties, liquid_density, make_batch,
    mix_derivatives, mix_helmholtz_energy_density, mix_properties, precompute_pure,
    pure_derivatives, pure_properties, pure_vle, vapor_pressure,
)
from feos_tpu_torch.kernels import build
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error, phi_d2, phi_d2_plain
from feos_tpu_torch.ops.derivatives import state_derivatives
from feos_tpu_torch.solvers.vle import _ETA_GRID
from feos_tpu_torch.utils import masked_sum
from feos_tpu_torch.units import KMOL_M3_TO_REDUCED, REDUCED_TO_PA_PER_KT, RGAS

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "pure_helmholtz.json"
MIX_GOLDEN = ROOT / "tests" / "golden" / "mix_helmholtz.json"
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
# phases 6-10: rows rerun on the CPU through the plain path, Adam steps, the
# share of critical rows whose VLE must converge at 0.98 T_c (the pure VLE of
# both packages fails within 2% of T_c on 0.2% of make_batch rows, small-m
# associating ones), and the f64 noise of a liquid's p~ in units of
# rho dp~/drho (1.5e-16 measured on the CPU)
N_CPU = 2_000
FIT_STEPS = 3
VLE_NEAR_CRITICAL = 0.995
P_NOISE = 1e-14
# phases 11-12: binary mixtures.  Config 3 of benchmarks/run_all.py and the
# non-associating pair of tests/test_compat.py, with the JAX package's and the
# C++ oracle's pressures at T = linspace(140, 160, 4) (config 3) and 150 K,
# printed to 8 and 2 decimals; rows rerun on the CPU; the golden file's bars
MIX_SIZES = (4_096, 100_000)
MIX_REPS = 3
N_CPU_MIX = 512
CONFIG3 = [[1, 3.5, 150, 0, 0.02, 1500, 1, 1], [1, 3.5, 200, 0, 0.03, 2500, 1, 1]]
CONFIG3_KIJ = [-0.15, 1000.0]
CONFIG3_ANCHORS = {
    "bubble": [345.42092106, 809.86800143, 1757.14938513, 3562.20472155],
    "dew": [0.06703126, 0.2419615, 0.77999089, 2.27776462],
}
NONASSOC = [[1, 3.5, 150, 0, 0, 0, 0, 0], [1, 3.5, 200, 0, 0, 0, 0, 0]]
NONASSOC_KIJ = [-0.15, 0.0]
NONASSOC_ANCHORS = {"bubble": 419901.14, "dew": 221902.57}
MIX_GOLDEN_ATOL = {"a": 1e-14, "p": 1e-14, "mu": 1e-14, "v": 1e-11}
# phase 13: gc-PC-SAFT with the sauer2014 segments.  Config 4 of
# benchmarks/run_all.py, and the C++ oracle's pressures at T = linspace(140,
# 160, 4), x1 = 0.5 (config 4) and of the 11 golden topologies at 300 K, x1 =
# 0.4 (cpu_backend.gc_vle_densities, 12 significant digits); the golden
# file's bars (tests/test_gc_pcsaft.py:57-73)
GC_GOLDEN = ROOT / "tests" / "golden" / "gc_helmholtz.json"
GC_SEGMENTS = ROOT / "tests" / "sauer2014_hetero.json"
GC_SIZES = (4_096, 100_000)
GC_ROWS = 4_096
GC_FIT_STEPS = 3
CONFIG4_SEGMENTS = [["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]
CONFIG4_BONDS = [[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]
CONFIG4_KAB = [("CH3", "CH2", -0.15)]
CONFIG4_PHI = [1.1, 0.98]
CONFIG4_ANCHORS = {
    "bubble": [37.9446592193, 88.9941522194, 192.029446905, 385.46094256],
    "dew": [0.400908291138, 1.36104131235, 4.09159097221, 11.0688250189],
}
GC_ASSOC_ANCHORS = {
    "bubble": [612586.682372, 174094.000449, 135422.792522, 75481.8364177, 12354.1815792,
               174843.210692, 95211.409215, 29648.9627044, 1744.54034816, 46252.6669947,
               36330.2301942],
    "dew": [224882.93475, 174054.064531, 15566.8224488, 22689.6814076, 10876.3836109,
            2822.10534028, 59594.4104233, 2785.10536401, 40.5648851765, 40.6257999271,
            632.126428475],
}
GC_GOLDEN_ATOL = {"a": 1e-14, "p": 1e-14, "mu": 1e-13, "v": 1e-11}
# phase 14: the binary workload built on bubble and dew points.  Rows of the
# temperature solves, of their CPU reruns and implicit-function check, and of
# fit_binary; the diagrams' grid (the JAX package's default)
T_SIZES = (4_096, 100_000)
N_CPU_T = 512
FIT_BINARY_ROWS = 4_096
FIT_BINARY_STEPS = 3
DIAGRAM_POINTS = 51
# phase 15: the isothermal pT flash.  Config 6 of benchmarks/run_all.py
# (config 3's pair at p = sqrt(p_bubble p_dew) of the port's own solves) at
# run_all.py's default 4,096 rows and at 100,000, with gradients at 4,096,
# and gc config 4 at its mid-window pressures; the C++ oracle splits every
# row of both (cpu_backend.mix_flash / gc_flash at the oracle's own
# mid-window pressures: tools/count_flash_ops.py --oracle);
# tests/test_flash.py's consistency bars, with its f64 floor of the liquid p~
FLASH_SIZES = (4_096, 100_000)
FLASH_REPS = 3
FLASH_GRAD_ROWS = 4_096
N_CPU_FLASH = 512
FLASH_P_NOISE = 2e-14
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


def log_sum(nans, x):
    """sum of log x over the converged rows (bench.py's loss)."""
    return torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, x))).sum()


def solves_and_grads(params, temperature):
    """The main path: vapor pressures, then d/dparams of sum log p over the
    converged rows (bench.py's loss)."""
    p = params.detach().requires_grad_()
    nans, vp = vapor_pressure(p, temperature)
    log_sum(nans, vp).backward()
    return nans, vp.detach(), p.grad


def main_path(dev, params, temperature, power):
    """Phase 5: the full-size main path, with the launch counts and rate."""
    stats = {}
    pure_vle(params, temperature, stats=stats)  # warm-up; loop iteration counts
    torch.cuda.synchronize()
    print(f"solver loops at B={B}: {stats}")

    phi_d2.launches = 0
    phi_d2.launches_by_k = {}
    nans, vp, grad = solves_and_grads(params, temperature)
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
    return launches, by_k, nans, vp


def on_card(fn):
    """``(fn(), seconds, launches, launches by k)``: the phi_d2 counts are
    set to 0 just before ``fn`` runs and read just after."""
    torch.cuda.synchronize()
    phi_d2.launches = 0
    phi_d2.launches_by_k = {}
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, phi_d2.launches, dict(phi_d2.launches_by_k)


def report(phase, name, nans, seconds, launches, by_k):
    n_ok = int((~nans).sum())
    print(f"phase {phase} {name}: converged {n_ok} of {nans.numel()}, "
          f"{seconds * 1e3:.1f} ms, phi_d2 launches {launches}, by k {by_k}")
    return {"launches": launches, "by_k": {str(k): n for k, n in sorted(by_k.items())},
            "ms": seconds * 1e3}


def cpu(*xs):
    """The first N_CPU rows of each tensor, as CPU tensors."""
    return [x[:N_CPU].cpu() for x in xs]


def agree(name, nans, card, cpu_nans, cpu_vals, rtol, floor=None):
    """The card's results against the plain path's on the CPU, all CPU
    tensors of the same rows: equal masks, and |card - cpu| <= rtol |cpu|
    (+ a per-row ``floor``) on the converged rows."""
    check(torch.equal(nans, cpu_nans),
          f"{name}: card and CPU masks differ on {int((nans != cpu_nans).sum())} rows")
    ok = ~nans
    allow = rtol * cpu_vals.abs() + (0.0 if floor is None else floor)
    err = (card - cpu_vals).abs()
    same = err == 0.0  # exact zeros included
    worst = float(torch.where(same, 0.0, err / allow)[ok].max())
    rel = float(torch.where(same, 0.0, err / cpu_vals.abs())[ok].max())
    print(f"  card vs CPU {name}, {len(nans)} values: masks equal, max rel err {rel:.3e}, "
          f"max err / allowed {worst:.3e} (rtol {rtol:g})")
    check(worst <= 1.0, f"{name}: card and CPU differ beyond rtol {rtol:g}")


def liquid_densities(params, temperature, p_sat):
    """Phase 6: liquid densities at the vapor pressures of phase 5 and
    saturated liquid densities, each with the gradient of sum log rho."""
    def run(fn, *args):
        p = params.detach().requires_grad_()
        nans, rho = fn(p, *args)
        log_sum(nans, rho).backward()
        return nans, rho.detach(), p.grad

    paths, out = {}, {}
    for name, fn, args in (
        ("liquid_density", liquid_density, (temperature, p_sat)),
        ("equilibrium_liquid_density", equilibrium_liquid_density, (temperature,)),
    ):
        (nans, rho, grad), sec, n, by_k = on_card(lambda: run(fn, *args))
        paths[name] = report(6, name, nans, sec, n, by_k)
        check(n > 0, f"{name} launched no phi_d2 kernel")
        check(int((~nans).sum()) >= MIN_CONVERGED, f"{name}: too few rows converged")
        check(bool(torch.isfinite(grad).all()), f"{name}: non-finite gradients")
        with torch.no_grad():
            cpu_nans, cpu_rho = fn(*cpu(params, *args))
        agree(name, *cpu(nans, rho), cpu_nans, cpu_rho, 1e-10)
        out[name] = (nans, rho)
    (nans_l, rho_l), (nans_e, rho_e) = out.values()
    both = ~nans_l & ~nans_e
    rel = float((rho_l / rho_e - 1.0).abs()[both].max())
    print(f"  liquid at p_sat vs equilibrium liquid on {int(both.sum())} rows: max rel "
          f"diff {rel:.3e} (rtol 1e-9)")
    check(rel < 1e-9, "liquid density at p_sat differs from the equilibrium liquid")
    return nans_l, rho_l, paths


def critical_points(params):
    """Phase 7: critical points with the gradient of sum T_c; the critical
    condition at the returned states, and the VLE's reach around T_c."""
    stats = {}

    def run():
        p = params.detach().requires_grad_()
        nans, t_c, rho_c = critical_point(p, stats=stats)
        torch.where(nans, 0.0, t_c).sum().backward()
        return nans, t_c.detach(), rho_c.detach(), p.grad

    (nans, t_c, rho_c, grad), sec, n, by_k = on_card(run)
    path = report(7, "critical_point", nans, sec, n, by_k)
    path["newton"] = stats["newton"]
    print(f"  critical Newton iterations {stats['newton']} (cap 60)")
    check(n > 0, "critical_point launched no phi_d2 kernel")
    check(bool(torch.isfinite(grad).all()), "critical_point: non-finite gradients")
    ok = ~nans
    with torch.no_grad():
        rho = rho_c * KMOL_M3_TO_REDUCED
        _, pt, dpt = pure_derivatives(PureParams.from_tensor(params), t_c, rho)
        margin = float((dpt.abs() / (pt / rho))[ok].max())
        lo, _ = vapor_pressure(params[ok], 0.98 * t_c[ok])
        hi, _ = vapor_pressure(params[ok], 1.03 * t_c[ok])
    n_lo = int((~lo).sum())
    print(f"  |dp~/drho| / (p~/rho) at the critical states: max {margin:.3e} (bound 1e-5); "
          f"vapor pressure converges at 0.98 T_c on {n_lo} of {int(ok.sum())} rows "
          f"(floor {VLE_NEAR_CRITICAL:g} of them), at 1.03 T_c on {int((~hi).sum())}")
    check(margin < 1e-5, "the critical condition does not hold")
    check(n_lo >= VLE_NEAR_CRITICAL * int(ok.sum()), "VLE fails below T_c")
    check(bool(hi.all()), "VLE converges above T_c")
    with torch.no_grad():
        cpu_nans, cpu_t, cpu_rho = critical_point(*cpu(params))
    agree("critical_point T_c", *cpu(nans, t_c), cpu_nans, cpu_t, 1e-9)
    agree("critical_point rho_c", *cpu(nans, rho_c), cpu_nans, cpu_rho, 1e-9)
    return path


def boiling_temperatures(params, temperature, p_sat, nans_vp):
    """Phase 8: boiling temperatures at phase 5's vapor pressures from
    0.9 T, with the gradient of sum T_b; the round trip to T."""
    stats = {}

    def run():
        p = params.detach().requires_grad_()
        nans, t_b = boiling_temperature(p, p_sat, 0.9 * temperature, stats=stats)
        torch.where(nans, 0.0, t_b).sum().backward()
        return nans, t_b.detach(), p.grad

    (nans, t_b, grad), sec, n, by_k = on_card(run)
    path = report(8, "boiling_temperature", nans, sec, n, by_k)
    path["outer"] = stats["outer"]
    both = ~nans & ~nans_vp
    rel = float((t_b / temperature - 1.0).abs()[both].max())
    print(f"  secant outer iterations {stats['outer']}; round trip |T_b/T - 1| on "
          f"{int(both.sum())} rows: max {rel:.3e} (bound 1e-9)")
    check(n > 0, "boiling_temperature launched no phi_d2 kernel")
    check(int((~nans).sum()) >= MIN_CONVERGED, "boiling_temperature: too few rows converged")
    check(rel < 1e-9, "boiling temperature round trip")
    check(bool(torch.isfinite(grad).all()), "boiling_temperature: non-finite gradients")
    with torch.no_grad():
        p_cpu, t_cpu, ps_cpu = cpu(params, temperature, p_sat)
        cpu_nans, cpu_t = boiling_temperature(p_cpu, ps_cpu, 0.9 * t_cpu)
    agree("boiling_temperature", *cpu(nans, t_b), cpu_nans, cpu_t, 1e-9)
    return path


def liquid_pressure_noise(params, temperature, rho):
    """``(rho dp~/drho, the f64 evaluation noise of the liquid p~)``: the
    liquid's p~ = rho - phi + rho phi' is a difference of terms of the size
    rho dp~/drho, so it carries rounding of P_NOISE times that, which is a
    large fraction of p~ where the vapor pressure is low."""
    _, _, dpt = pure_derivatives(PureParams.from_tensor(params), temperature, rho)
    stiff = rho * dpt
    return stiff, P_NOISE * stiff


@torch.no_grad()
def residual_properties(params, temperature, p_sat, nans_l, rho_l):
    """Phase 9: the residual property set at phase 6's liquid densities.

    The liquid p~ carries f64 noise of P_NOISE rho dp~/drho (see
    liquid_pressure_noise), so each field that depends on p~ may differ
    from p_sat or from the CPU by its sensitivity to p~ times that noise.
    """
    ok = ~nans_l
    rho = torch.where(ok, rho_l * KMOL_M3_TO_REDUCED, 1e-3)
    props, sec, n, by_k = on_card(lambda: pure_properties(params, temperature, rho))
    path = report(9, "pure_properties", nans_l, sec, n, by_k)
    stiff, noise = liquid_pressure_noise(params, temperature, rho)
    to_pa = temperature * REDUCED_TO_PA_PER_KT
    # rows whose p~ f64 resolves to 1%: elsewhere Z = p~/rho may round to
    # <= 0 and ln phi = mu - ln Z is not defined
    resolved = ok & (noise * to_pa < 1e-2 * p_sat)
    print(f"  rows whose liquid p~ is resolved to 1% in f64: {int(resolved.sum())} of "
          f"{int(ok.sum())} (lowest p_sat {float(p_sat[ok].min()):.3e} Pa)")
    for name, field in zip(ResidualProperties._fields, props):
        rows = resolved if name == "ln_phi" else ok
        check(bool(torch.isfinite(field[rows]).all()), f"pure_properties {name} not finite")
    err = (props.pressure - p_sat).abs()
    n_plain = int((err <= 1e-8 * p_sat)[ok].sum())
    worst = float((err / (1e-8 * p_sat + noise * to_pa))[ok].max())
    print(f"  pressure vs p_sat: within rtol 1e-8 on {n_plain} of {int(ok.sum())} rows; "
          f"max err / (1e-8 p_sat + {P_NOISE:g} rho dp/drho) {worst:.3e}; max "
          f"{P_NOISE:g} rho dp/drho / p_sat {float((noise * to_pa / p_sat)[ok].max()):.3e}")
    check(worst <= 1.0, "pure_properties pressure differs from p_sat")
    # sensitivity of each field to p~, times the noise of p~
    rt = RGAS * temperature
    ptilde = props.pressure / to_pa
    # c_p_res/R = c_v_res/R + x - 1 with x = (p~ + T p~_T)^2 / (rho stiff)
    x = props.c_p_res / RGAS - props.c_v_res / RGAS + 1.0
    floors = {
        "pressure": to_pa * noise,
        "compressibility": noise / rho,
        "h_res": rt * noise / rho,
        "g_res": rt * noise / rho,
        "c_p_res": RGAS * 2.0 * torch.sqrt(x.abs() / (rho * stiff)) * noise,
        "ln_phi": noise / ptilde.abs(),
    }
    cpu_props = pure_properties(*cpu(params, temperature, rho))
    for name, field, cpu_field in zip(ResidualProperties._fields, props, cpu_props):
        out, floor = cpu(~(resolved if name == "ln_phi" else ok))[0], floors.get(name)
        agree(f"pure_properties {name}", out, *cpu(field), out, cpu_field, 1e-10,
              None if floor is None else cpu(floor)[0])
    return path


def fit(params_np, temperature, p_sat, rho_l):
    """Phase 10: FIT_STEPS Adam steps from 1.01 times the parameters, per
    row, on phase 5's vapor pressures and phase 6's liquid densities at
    pressure p_sat (rows where either failed are left out).  The loss
    couples the rows, so the card-against-CPU check fits the first N_CPU
    rows on both; it runs first and so also warms up ``torch.optim``."""
    keep = torch.isfinite(p_sat) & torch.isfinite(rho_l)
    data = (temperature[keep], p_sat[keep], rho_l[keep])
    start = params_np[keep.cpu().numpy()] * 1.01

    def run(start, temperature, p_sat, rho_l):
        return fit_pure(start, temperature, p_sat=p_sat, rho_liq=rho_l, pressure=p_sat,
                        steps=FIT_STEPS)

    card = run(start[:N_CPU], *(x[:N_CPU] for x in data))
    on_cpu = run(start[:N_CPU], *cpu(*data))
    res, sec, n, by_k = on_card(lambda: run(start, *data))
    losses = res.loss_history.cpu().numpy()
    print(f"phase 10 fit_pure: B={len(start)}, {FIT_STEPS} steps in {sec * 1e3:.1f} ms, "
          f"step {sec / FIT_STEPS * 1e3:.1f} ms, losses {losses.tolist()}, phi_d2 launches "
          f"{n} ({n / FIT_STEPS:g} a step), by k {by_k}")
    check(n > 0, "fit_pure launched no phi_d2 kernel")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], "fit_pure loss")
    for name, a, b in (("loss history", card.loss_history, on_cpu.loss_history),
                       ("parameters", card.parameters.flatten(), on_cpu.parameters.flatten())):
        no = torch.zeros(b.shape, dtype=torch.bool)
        agree(f"fit_pure {name}", no, a.cpu(), no, b, 1e-10)
    return {"launches_per_step": n / FIT_STEPS, "ms_per_step": sec / FIT_STEPS * 1e3,
            "by_k": {str(k): v for k, v in sorted(by_k.items())}, "steps": FIT_STEPS}


def mixture_derivatives(dev):
    """Phase 11: the mixture derivative set on the card for the 14 golden
    regimes against the golden values, then the regimes tiled to B rows,
    timed, and their first N_CPU rows against the CPU."""
    gold = json.loads(MIX_GOLDEN.read_text())
    n = len(gold["params"])

    def inputs(rows, d):
        idx = np.arange(rows) % n
        return (f64(np.asarray(gold["params"])[idx], d), f64(np.asarray(gold["kij"])[idx], d),
                f64(np.full(rows, gold["temperature"]), d),
                f64(np.tile(gold["density"], (rows, 1)), d))

    with torch.no_grad():
        out = mix_derivatives(*inputs(n, dev))
    for key, got in zip(("a", "p", "mu", "v"), out):
        err = float(np.max(np.abs(got.cpu().numpy() - np.asarray(gold[key]))))
        print(f"phase 11 mixture derivatives vs golden {key}: max abs err {err:.3e} "
              f"(atol {MIX_GOLDEN_ATOL[key]:g})")
        check(err <= MIX_GOLDEN_ATOL[key], f"mixture derivatives {key} off the golden values")

    args = inputs(B, dev)
    with torch.no_grad():
        mix_derivatives(*args)  # warm-up
        out, sec, launches, by_k = on_card(lambda: mix_derivatives(*args))
        cpu_out = mix_derivatives(*inputs(N_CPU, "cpu"))
    print(f"phase 11 mixture derivatives at B={B} (the 14 regimes tiled): {sec * 1e3:.1f} ms, "
          f"phi_d2 launches {launches}")
    check(launches == 0, "the mixture path launched phi_d2")
    for key, got, want in zip(("A", "p~", "mu", "v"), out, cpu_out):
        got, want = got[:N_CPU].cpu().flatten(), want.flatten()
        no = torch.zeros(got.shape, dtype=torch.bool)
        agree(f"mixture derivatives {key}", no, got, no, want, 1e-12)
    return {"launches": launches, "by_k": {}, "ms": sec * 1e3}


def mixture_run(fn, params, kij, temperature, x1, p0, state0=None, stats=None):
    """One bubble or dew call with the gradient of sum log p over the
    converged rows in the parameters and kij: ``(nans, p, state, [d/dparams,
    d/dkij])``."""
    p = params.detach().requires_grad_()
    k = kij.detach().requires_grad_()
    pr, nans, state = fn(p, k, temperature, x1, p0, state0=state0, state_output=True,
                         stats=stats)
    log_sum(nans, pr).backward()
    return nans, pr.detach(), state, [p.grad, k.grad]


def timed_solves(phase, label, run, rows):
    """A bubble or dew path's cold call with its loop iterations, the median
    of MIX_REPS synchronised calls, and a warm start from the cold call's
    state, each with the phi_d2 launches it made; ``run(state0=None,
    stats=None)`` returns ``(nans, p, state, gradients)``.  Checks that no
    call launched phi_d2, that every row converged with finite gradients,
    and that the warm start is within 1e-9 of the cold values.  Returns the
    cold call's ``(nans, p, gradients)`` and the path's record."""
    stats, warm_stats = {}, {}
    (nans, p, state, grads), sec, launches, _ = on_card(lambda: run(stats=stats))
    n_ok = int((~nans).sum())
    times = []
    for _ in range(MIX_REPS):
        _, t, n, _ = on_card(run)
        times.append(t)
        launches += n
    step = statistics.median(times)
    (w_nans, w_p, _, _), w_sec, n, _ = on_card(lambda: run(state0=state, stats=warm_stats))
    launches += n
    ok = ~nans & ~w_nans
    warm_rel = float((w_p / p - 1.0).abs()[ok].max())
    print(f"phase {phase} {label}: converged {n_ok} of {rows}, first call {sec * 1e3:.1f} ms, "
          f"median {step * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} ms "
          f"({n_ok / step:.1f} converged solves+gradients/s), loops {stats}, phi_d2 "
          f"launches {launches}; warm start {w_sec * 1e3:.1f} ms, loops {warm_stats}, "
          f"converged {int((~w_nans).sum())}, max |p_warm/p - 1| {warm_rel:.3e} (bound 1e-9)")
    check(launches == 0, f"{label}: the path launched phi_d2")
    check(n_ok == rows, f"{label}: only {n_ok} of {rows} rows converged")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    check(bool(w_nans.eq(nans).all()) and warm_rel < 1e-9, f"{label}: warm start")
    return (nans, p, grads), {
        "launches": launches, "by_k": {}, "ms": step * 1e3, "first_ms": sec * 1e3,
        "converged": n_ok, "rows": rows, "loops": stats, "warm_ms": w_sec * 1e3,
        "warm_loops": warm_stats}


def agree_gradients(label, names, card, on_cpu):
    """Gradients of the card against the CPU's, at 1e-9 with a floor of
    1e-12 of the largest."""
    for what, g, c in zip(names, card, on_cpu):
        g, c = g.cpu().flatten(), c.flatten()
        no = torch.zeros(g.shape, dtype=torch.bool)
        agree(f"{label} d/d{what}", no, g, no, c, 1e-9, 1e-12 * float(c.abs().max()))


def mixture_case(label, fn, system, kij, temperature, dev, anchor=None):
    """Phase 12, one direction at one size (:func:`timed_solves`), and the
    first N_CPU_MIX rows on the CPU (equal masks, p at 1e-10, gradients at
    1e-9)."""
    rows = len(temperature)
    args = (f64(np.tile(system, (rows, 1, 1)), dev), f64(np.tile(kij, (rows, 1)), dev),
            f64(temperature, dev), f64(np.full(rows, 0.5), dev), f64(np.full(rows, 1e5), dev))
    (nans, p, grads), record = timed_solves(12, label, partial(mixture_run, fn, *args), rows)
    if anchor is not None:
        err = float((p - anchor).abs().max())
        # the anchor's last printed decimal, and the solve's 1e-9
        print(f"  {label} vs its anchor {anchor:.2f} Pa: max abs err {err:.3e} "
              f"(5e-3 + 1e-9 of it)")
        check(err < 5e-3 + 1e-9 * anchor, f"{label} off its anchor")

    c_nans, c_p, _, c_grads = mixture_run(fn, *(x[:N_CPU_MIX].cpu() for x in args))
    agree(f"{label} p", nans[:N_CPU_MIX].cpu(), p[:N_CPU_MIX].cpu(), c_nans, c_p, 1e-10)
    agree_gradients(label, ("params", "kij"), (g[:N_CPU_MIX] for g in grads), c_grads)
    return record


def profile(phase, label, fn, record, what="solve + backward"):
    """Where the time of one call of ``fn`` goes: the card's busy time
    (:func:`device_profile`) against the path's unprofiled median, added to
    its ``record``."""
    t0 = time.perf_counter()
    busy, kernels, host_ops = device_profile(fn)
    record["profile_s"] = time.perf_counter() - t0
    step = record["ms"]
    idle = f"idle share {1.0 - busy / step:.3f}" if kernels else "busy time not measured"
    print(f"phase {phase} profile of {label} ({what}): card busy {busy:.1f} ms in "
          f"{kernels} kernels, {host_ops} aten ops on the host; {idle} of the unprofiled "
          f"median {step:.1f} ms; the profile took {record['profile_s']:.1f} s")
    record.update(busy_ms=busy if kernels else None, kernels=kernels, host_ops=host_ops)


def device_profile(fn):
    """``(device ms, kernels, host ops)`` of one call of ``fn`` under
    ``torch.profiler``: the summed time and count of the kernels the card
    ran, and the aten ops the host dispatched.  It reads the profiler's raw
    events: ``prof.events()`` builds an event tree first, which took 171 s
    for the 5 * 10^5 events of a config 3 bubble-temperature call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_ns, kernels, host_ops = 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device_ns += e.duration_ns()
            kernels += 1
        elif e.name().startswith("aten::"):
            host_ops += 1
    return device_ns / 1e6, kernels, host_ops


def mixtures(dev):
    """Phase 12: bubble and dew pressures with gradients."""
    t4 = f64(np.linspace(140.0, 160.0, 4), dev)
    for name, fn in (("bubble", bubble_point), ("dew", dew_point)):
        with torch.no_grad():
            p, nans = fn(f64(np.tile(CONFIG3, (4, 1, 1)), dev), f64(np.tile(CONFIG3_KIJ, (4, 1)), dev),
                         t4, f64(np.full(4, 0.5), dev), f64(np.full(4, 1e5), dev))
        err = float((p.cpu() - f64(CONFIG3_ANCHORS[name], "cpu")).abs().max())
        print(f"phase 12 config 3 {name} anchors {p.cpu().tolist()} Pa: max abs err {err:.3e} "
              f"(the anchors' last decimal, 5e-9)")
        check(not bool(nans.any()) and err <= 5e-9 + 1e-15 * float(p.max()),
              f"config 3 {name} anchors")
    paths = {}
    for rows in MIX_SIZES:
        temperature = np.linspace(140.0, 160.0, rows)
        for name, fn in (("bubble", bubble_point), ("dew", dew_point)):
            label = f"config 3 {name} B={rows}"
            paths[label] = mixture_case(label, fn, CONFIG3, CONFIG3_KIJ, temperature, dev)
    # where the time of the largest call goes
    rows = MIX_SIZES[-1]
    args = (f64(np.tile(CONFIG3, (rows, 1, 1)), dev), f64(np.tile(CONFIG3_KIJ, (rows, 1)), dev),
            f64(np.linspace(140.0, 160.0, rows), dev), f64(np.full(rows, 0.5), dev),
            f64(np.full(rows, 1e5), dev))
    label = f"config 3 bubble B={rows}"
    profile(12, label, lambda: mixture_run(bubble_point, *args), paths[label])
    for name, fn in (("bubble", bubble_point), ("dew", dew_point)):
        label = f"non-associating {name} B={MIX_SIZES[0]}"
        paths[label] = mixture_case(label, fn, NONASSOC, NONASSOC_KIJ,
                                    np.full(MIX_SIZES[0], 150.0), dev, NONASSOC_ANCHORS[name])
    return paths


def sauer2014():
    """The segment identifiers and the 8-tuple of segment columns."""
    segs = json.loads(GC_SEGMENTS.read_text())
    cols = ("m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb")
    return ([r["identifier"] for r in segs],
            tuple(np.array([r["model_record"].get(k, 0.0) for r in segs]) for k in cols))


class GcSystem:
    """A gc system on ``rows`` rows: the golden topologies cycled, or config
    4 on every row; ``model(dev, n)`` is the ``GcPcSaftMix`` of its first n
    rows on ``dev``."""

    def __init__(self, rows, golden=False):
        self.ident, self.parameter = sauer2014()
        if golden:
            gold = json.loads(GC_GOLDEN.read_text())
            idx = np.arange(rows) % len(gold["labels"])
            self.segments = [gold["segment_lists"][i] for i in idx]
            self.bonds = [gold["bond_lists"][i] for i in idx]
            self.records = [tuple(k) for k in gold["kab_list"]]
            self.phi = np.asarray(gold["phi"])[idx]
        else:
            self.segments, self.bonds = [CONFIG4_SEGMENTS] * rows, [CONFIG4_BONDS] * rows
            self.records, self.phi = CONFIG4_KAB, np.tile(CONFIG4_PHI, (rows, 1))

    def model(self, dev, n=None):
        return GcPcSaftMix(self.ident, self.parameter, self.segments[:n], self.bonds[:n],
                           self.records, self.phi[:n], device=dev)


def gc_derivative_set(dev):
    """Phase 13(a): the gc derivative set on the card for the 11 golden
    topologies against the golden values, then tiled to B rows, timed, and
    its first N_CPU rows against the CPU."""
    gold = json.loads(GC_GOLDEN.read_text())
    n = len(gold["labels"])

    def state(rows, d):
        return (f64(np.full(rows, gold["temperature"]), d),
                f64(np.tile(gold["density"], (rows, 1)), d))

    with torch.no_grad():
        out = GcSystem(n, golden=True).model(dev).derivatives(*state(n, dev))
    for key, got in zip(("a", "p", "mu", "v"), out):
        err = float(np.max(np.abs(got.cpu().numpy() - np.asarray(gold[key]))))
        print(f"phase 13 gc derivatives vs golden {key}: max abs err {err:.3e} "
              f"(atol {GC_GOLDEN_ATOL[key]:g})")
        check(err <= GC_GOLDEN_ATOL[key], f"gc derivatives {key} off the golden values")

    system = GcSystem(B, golden=True)
    model, args = system.model(dev), state(B, dev)
    with torch.no_grad():
        model.derivatives(*args)  # warm-up
        out, sec, launches, _ = on_card(lambda: model.derivatives(*args))
        cpu_out = system.model("cpu", N_CPU).derivatives(*state(N_CPU, "cpu"))
    print(f"phase 13 gc derivatives at B={B} (the 11 topologies tiled): {sec * 1e3:.1f} ms, "
          f"phi_d2 launches {launches}")
    check(launches == 0, "the gc derivative path launched phi_d2")
    for key, got, want in zip(("A", "p~", "mu", "v"), out, cpu_out):
        got, want = got[:N_CPU].cpu().flatten(), want.flatten()
        no = torch.zeros(got.shape, dtype=torch.bool)
        agree(f"gc derivatives {key}", no, got, no, want, 1e-12)
    return {"launches": launches, "by_k": {}, "ms": sec * 1e3}


def gc_run(model, name, temperature, x1, p0, state0=None, stats=None):
    """One gc bubble or dew call with the gradient of sum log p over the
    converged rows in the segment parameters, k_ab and phi."""
    model.zero_grad(set_to_none=True)
    fn = model.bubble_point if name == "bubble" else model.dew_point
    p, nans, state = fn(temperature, x1, p0, state0=state0, state_output=True, stats=stats)
    log_sum(nans, p).backward()
    return nans, p.detach(), state, [x.grad for x in (model.parameter, model.kab, model.phi)]


def gc_case(label, name, system, temperature, x1, dev):
    """Phase 13(b, c), one direction at one size (:func:`timed_solves`), and
    the first N_CPU_MIX rows on the CPU: equal masks and p at 1e-10 against
    this call, and the gradients (shared by the rows) of those rows alone on
    the card and on the CPU at 1e-9."""
    rows = len(temperature)
    args = (f64(temperature, dev), f64(x1, dev), f64(np.full(rows, 1e5), dev))
    (nans, p, _), record = timed_solves(13, label, partial(gc_run, system.model(dev), name,
                                                           *args), rows)
    n = N_CPU_MIX
    card = gc_run(system.model(dev, n), name, *(x[:n] for x in args))
    on_cpu = gc_run(system.model("cpu", n), name, *(x[:n].cpu() for x in args))
    agree(f"{label} p", nans[:n].cpu(), p[:n].cpu(), on_cpu[0], on_cpu[1], 1e-10)
    agree_gradients(label, ("segment parameters", "k_ab", "phi"), card[3], on_cpu[3])
    return record, p


def gc_anchors(label, name, system, temperature, x1, dev, anchors):
    """The card's pressures on the anchors' rows against the C++ oracle's,
    at rtol 1e-9 (the oracle tests' bar)."""
    n = len(anchors)
    with torch.no_grad():
        fn = getattr(system.model(dev, n), f"{name}_point")
        p, nans = fn(f64(temperature[:n], dev), f64(x1[:n], dev), f64(np.full(n, 1e5), dev))
    rel = float((p.cpu() / f64(anchors, "cpu") - 1.0).abs().max())
    print(f"phase 13 {label} vs the oracle's {n} anchors: max rel err {rel:.3e} (rtol 1e-9)")
    check(not bool(nans.any()) and rel <= 1e-9, f"{label} off the oracle's anchors")


def gc_mixtures(dev):
    """Phase 13(b-d): config 4 and the golden topologies, bubble and dew,
    with gradients; the profile of the largest bubble call; fit_gc."""
    paths, p_config4 = {}, None
    for name in ("bubble", "dew"):
        gc_anchors(f"config 4 {name}", name, GcSystem(4), np.linspace(140.0, 160.0, 4),
                   np.full(4, 0.5), dev, CONFIG4_ANCHORS[name])
    for rows in GC_SIZES:
        temperature, x1 = np.linspace(140.0, 160.0, rows), np.full(rows, 0.5)
        for name in ("bubble", "dew"):
            label = f"gc config 4 {name} B={rows}"
            paths[label], p = gc_case(label, name, GcSystem(rows), temperature, x1, dev)
            if rows == GC_ROWS and name == "bubble":
                p_config4 = p
    rows = GC_SIZES[-1]
    model = GcSystem(rows).model(dev)
    args = (f64(np.linspace(140.0, 160.0, rows), dev), f64(np.full(rows, 0.5), dev),
            f64(np.full(rows, 1e5), dev))
    label = f"gc config 4 bubble B={rows}"
    profile(13, label, lambda: gc_run(model, "bubble", *args), paths[label])

    # every association regime: the golden topologies at 300 K, x1 = 0.4
    golden = GcSystem(GC_ROWS, golden=True)
    temperature, x1 = np.full(GC_ROWS, 300.0), np.full(GC_ROWS, 0.4)
    for name in ("bubble", "dew"):
        label = f"gc golden topologies {name} B={GC_ROWS}"
        gc_anchors(label, name, golden, temperature, x1, dev, GC_ASSOC_ANCHORS[name])
        paths[label], _ = gc_case(label, name, golden, temperature, x1, dev)
    paths["fit_gc"] = gc_fit(dev, p_config4)
    return paths


def gc_fit(dev, p_data):
    """Phase 13(d): GC_FIT_STEPS steps of fit_gc on the GC_ROWS config 4
    rows, from k_ab = 0, against the bubble pressures at k_ab = -0.15; the
    fit of the first N_CPU_MIX rows on the card against the CPU."""
    ident, parameter = sauer2014()

    def run(rows, d):
        return fit_gc(ident, parameter, [CONFIG4_SEGMENTS], [CONFIG4_BONDS],
                      [("CH3", "CH2", 0.0)], np.linspace(140.0, 160.0, GC_ROWS)[:rows],
                      np.full(rows, 0.5), p_data[:rows].cpu().numpy(), phi=CONFIG4_PHI,
                      steps=GC_FIT_STEPS, device=d)

    card, on_cpu = run(N_CPU_MIX, dev), run(N_CPU_MIX, "cpu")
    res, sec, launches, _ = on_card(lambda: run(GC_ROWS, dev))
    losses = res.loss_history.cpu().numpy()
    print(f"phase 13 fit_gc: B={GC_ROWS}, {GC_FIT_STEPS} steps (and the cold solve that "
          f"seeds them) in {sec * 1e3:.1f} ms, {sec / GC_FIT_STEPS * 1e3:.1f} ms a step, "
          f"losses {losses.tolist()}, k_ab {res.parameters.tolist()}, phi_d2 launches "
          f"{launches}")
    check(launches == 0, "fit_gc launched phi_d2")
    check(bool(np.isfinite(losses).all()) and bool(np.all(np.diff(losses) < 0.0)),
          "fit_gc loss does not fall")
    for what, a, b in (("loss history", card.loss_history, on_cpu.loss_history),
                       ("k_ab", card.parameters, on_cpu.parameters)):
        no = torch.zeros(b.shape, dtype=torch.bool)
        agree(f"fit_gc {what}", no, a.cpu(), no, b, 1e-10)
    return {"launches": launches, "by_k": {}, "ms_per_step": sec / GC_FIT_STEPS * 1e3,
            "steps": GC_FIT_STEPS, "losses": losses.tolist()}


def temperature_run(fn, params, kij, pressure, x1, t0, stats=None):
    """One bubble or dew temperature call with the gradient of sum log T
    over the converged rows in the parameters and kij: ``(nans, T,
    [d/dparams, d/dkij])``."""
    p = params.detach().requires_grad_()
    k = kij.detach().requires_grad_()
    t, nans = fn(p, k, pressure, x1, t0, stats=stats)
    log_sum(nans, t).backward()
    return nans, t.detach(), [p.grad, k.grad]


def timed_calls(label, run, rows):
    """Phase 14: a path's first call with its loop counts (``stats``), then
    the median of MIX_REPS synchronised calls, each with the phi_d2 launches
    it made; ``run(stats=None)`` returns ``(nans, values, gradients)``.
    Checks that no call launched phi_d2, that every row converged and that
    the gradients are finite.  Returns the first call's output and the
    path's record."""
    stats = {}
    (nans, values, grads), sec, launches, _ = on_card(lambda: run(stats=stats))
    n_ok = int((~nans).sum())
    times = []
    for _ in range(MIX_REPS):
        _, t, n, _ = on_card(run)
        times.append(t)
        launches += n
    step = statistics.median(times)
    print(f"phase 14 {label}: converged {n_ok} of {rows}, first call {sec * 1e3:.1f} ms, "
          f"median {step * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} ms "
          f"({n_ok / step:.1f} converged solves+gradients/s), loops {stats}, phi_d2 "
          f"launches {launches}")
    check(launches == 0, f"{label}: the path launched phi_d2")
    check(n_ok == rows, f"{label}: only {n_ok} of {rows} rows converged")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    return (nans, values, grads), {
        "launches": launches, "by_k": {}, "ms": step * 1e3, "first_ms": sec * 1e3,
        "converged": n_ok, "rows": rows, "loops": stats}


def recovers(label, t, temperature, rtol=1e-9):
    """The temperature solve at the pressures of ``temperature`` returns
    ``temperature``."""
    rel = float((t / temperature - 1.0).abs().max())
    print(f"  {label}: max |T / T_target - 1| {rel:.3e} (bound {rtol:g})")
    check(rel <= rtol, f"{label}: the temperatures are not recovered")


def implicit_function(label, fn, params, kij, t, x1, pressure, state, grads):
    """dT/dtheta (dp/dT) + dp/dtheta = 0 per row on the first N_CPU_T rows,
    theta the parameters and kij, with dp/dT and dp/dtheta from the pressure
    solve at T warm from the target's state; ``grads`` are the gradients of
    sum log T, so dT/dtheta = T grads.  The pressure solve differs from the
    re-attached one by the Newton's tolerance, hence 1e-8 of each row's
    largest dp/dtheta."""
    sl = slice(0, N_CPU_T)
    tt = t[sl].clone().requires_grad_()
    p = params[sl].detach().requires_grad_()
    k = kij[sl].detach().requires_grad_()
    pr, nans = fn(p, k, tt, x1[sl], pressure[sl], state0=state[sl])
    check(not bool(nans.any()), f"{label}: pressure solve at T failed")
    pr.sum().backward()
    worst = 0.0
    for g, dp in zip(grads, (p.grad, k.grad)):
        dt = (t[sl].reshape(-1, *([1] * (g.dim() - 1))) * g[sl])
        res = dt * tt.grad.reshape(dt.shape[:1] + (1,) * (dt.dim() - 1)) + dp
        scale = dp.reshape(len(dp), -1).abs().amax(1)
        worst = max(worst, float((res.reshape(len(res), -1).abs().amax(1) / scale).max()))
    print(f"  {label}: max |dT/dtheta dp/dT + dp/dtheta| / max|dp/dtheta| on {N_CPU_T} rows "
          f"{worst:.3e} (bound 1e-8)")
    check(worst <= 1e-8, f"{label}: the implicit-function identity does not hold")


def mixture_temperatures(dev):
    """Phase 14(a): config 3 bubble and dew temperatures at the port's own
    pressures of T = linspace(140, 160, B), from 1.05 T, with the gradient
    of sum log T; the implicit-function identity; the first N_CPU_T rows on
    the CPU.  Returns the paths, the 4,096-row bubble pressures (the data
    of 14(c)) and the 100,000-row bubble states (14(e))."""
    paths, data, states = {}, None, None
    for rows in T_SIZES:
        temperature = f64(np.linspace(140.0, 160.0, rows), dev)
        params = f64(np.tile(CONFIG3, (rows, 1, 1)), dev)
        kij = f64(np.tile(CONFIG3_KIJ, (rows, 1)), dev)
        x1 = f64(np.full(rows, 0.5), dev)
        for name, fn_p, fn_t in (("bubble", bubble_point, bubble_point_t),
                                 ("dew", dew_point, dew_point_t)):
            with torch.no_grad():
                target, nans, state = fn_p(params, kij, temperature, x1,
                                           f64(np.full(rows, 1e5), dev), state_output=True)
            check(not bool(nans.any()), f"config 3 {name} pressures at B={rows}")
            label = f"config 3 {name} T B={rows}"
            run = partial(temperature_run, fn_t, params, kij, target, x1, 1.05 * temperature)
            (nans, t, grads), paths[label] = timed_calls(label, run, rows)
            recovers(label, t, temperature)
            implicit_function(label, fn_p, params, kij, t, x1, target, state, grads)
            c0 = time.perf_counter()
            c_nans, c_t, c_grads = run_cpu_rows(run, N_CPU_T)
            print(f"  {label}: CPU rerun of {N_CPU_T} rows {time.perf_counter() - c0:.1f} s")
            agree(f"{label} T", nans[:N_CPU_T].cpu(), t[:N_CPU_T].cpu(), c_nans, c_t, 1e-10)
            agree_gradients(label, ("params", "kij"), (g[:N_CPU_T] for g in grads), c_grads)
            if name == "bubble" and rows == FIT_BINARY_ROWS:
                data = target
            if name == "bubble" and rows == T_SIZES[-1]:
                states = (params, kij, temperature, x1, state)
                profile(14, label, run, paths[label])
    return paths, data, states


def run_cpu_rows(run, n):
    """``run`` on the first n rows of its bound tensor arguments, on the
    CPU."""
    args = [x[:n].cpu() if torch.is_tensor(x) else x for x in run.args]
    return partial(run.func, *args)()


def gc_temperature_run(model, name, pressure, x1, t0, stats=None):
    """One gc bubble or dew temperature call with the gradient of sum log T
    over the converged rows in the segment parameters, k_ab and phi."""
    model.zero_grad(set_to_none=True)
    fn = model.bubble_point_t if name == "bubble" else model.dew_point_t
    t, nans = fn(pressure, x1, t0, stats=stats)
    log_sum(nans, t).backward()
    return nans, t.detach(), [x.grad for x in (model.parameter, model.kab, model.phi)]


def gc_temperatures(dev):
    """Phase 14(b): config 4 bubble and dew temperatures at the port's own
    pressures, as 14(a), with gradients in the segment parameters, k_ab and
    phi, the shared gradients of N_CPU_T-row runs on the card against the
    CPU; the golden topologies' bubble temperatures at N_CPU_T rows (every
    association regime), one call on each device.  Returns the paths and
    the 100,000-row bubble states (14(e))."""
    paths, states = {}, None
    for rows in T_SIZES:
        temperature = f64(np.linspace(140.0, 160.0, rows), dev)
        x1 = f64(np.full(rows, 0.5), dev)
        system = GcSystem(rows)
        model = system.model(dev)
        for name in ("bubble", "dew"):
            with torch.no_grad():
                target, nans, state = getattr(model, f"{name}_point")(
                    temperature, x1, f64(np.full(rows, 1e5), dev), state_output=True)
            check(not bool(nans.any()), f"config 4 {name} pressures at B={rows}")
            label = f"gc config 4 {name} T B={rows}"
            args = (target, x1, 1.05 * temperature)
            (nans, t, _), paths[label] = timed_calls(
                label, partial(gc_temperature_run, model, name, *args), rows)
            recovers(label, t, temperature)
            n = N_CPU_T
            c0 = time.perf_counter()
            card = gc_temperature_run(system.model(dev, n), name, *(x[:n] for x in args))
            on_cpu = gc_temperature_run(system.model("cpu", n), name,
                                        *(x[:n].cpu() for x in args))
            print(f"  {label}: {n} rows on the card and on the CPU "
                  f"{time.perf_counter() - c0:.1f} s")
            agree(f"{label} T", nans[:n].cpu(), t[:n].cpu(), on_cpu[0], on_cpu[1], 1e-10)
            agree_gradients(label, ("segment parameters", "k_ab", "phi"), card[2], on_cpu[2])
            if name == "bubble" and rows == T_SIZES[-1]:
                states = (model, temperature, x1, state)
                profile(14, label, partial(gc_temperature_run, model, name, *args),
                        paths[label])

    golden = GcSystem(N_CPU_T, golden=True)
    idx = np.arange(N_CPU_T) % len(GC_ASSOC_ANCHORS["bubble"])
    args = [f64(np.asarray(GC_ASSOC_ANCHORS["bubble"])[idx], "cpu"),
            f64(np.full(N_CPU_T, 0.4), "cpu"), f64(np.full(N_CPU_T, 315.0), "cpu")]
    label = f"gc golden topologies bubble T B={N_CPU_T}"
    stats = {}
    (nans, t, grads), sec, launches, _ = on_card(lambda: gc_temperature_run(
        golden.model(dev), "bubble", *(x.to(dev) for x in args), stats=stats))
    print(f"phase 14 {label}: converged {int((~nans).sum())} of {N_CPU_T}, one call "
          f"{sec * 1e3:.1f} ms, loops {stats}, phi_d2 launches {launches}")
    check(launches == 0 and not bool(nans.any()), f"{label}: launches or failed rows")
    recovers(label, t, 300.0)
    c0 = time.perf_counter()
    c_nans, c_t, c_grads = gc_temperature_run(golden.model("cpu"), "bubble", *args)
    print(f"  {label}: the CPU's call {time.perf_counter() - c0:.1f} s")
    agree(f"{label} T", nans.cpu(), t.cpu(), c_nans, c_t, 1e-10)
    agree_gradients(label, ("segment parameters", "k_ab", "phi"), grads, c_grads)
    paths[label] = {"launches": launches, "by_k": {}, "ms": sec * 1e3, "loops": stats}
    return paths, states


def binary_fit(dev, p_data):
    """Phase 14(c): FIT_BINARY_STEPS steps of fit_binary on the
    FIT_BINARY_ROWS config 3 rows from kij = 0, eps_AiBj = 900, against the
    bubble pressures at [-0.15, 1000]; the fit of the first N_CPU_T rows on
    the card against the CPU at 1e-8."""
    temperature = np.linspace(140.0, 160.0, FIT_BINARY_ROWS)

    def run(rows, d):
        return fit_binary(CONFIG3, temperature[:rows], np.full(rows, 0.5),
                          p_data[:rows].cpu().numpy(), kij0=0.0, epsilon_k_aibj0=900.0,
                          steps=FIT_BINARY_STEPS, device=d)

    c0 = time.perf_counter()
    card, on_cpu = run(N_CPU_T, dev), run(N_CPU_T, "cpu")
    print(f"phase 14 fit_binary: {N_CPU_T} rows on the card and on the CPU "
          f"{time.perf_counter() - c0:.1f} s")
    res, sec, launches, _ = on_card(lambda: run(FIT_BINARY_ROWS, dev))
    losses = res.loss_history.cpu().numpy()
    print(f"phase 14 fit_binary: B={FIT_BINARY_ROWS}, {FIT_BINARY_STEPS} steps (and the cold "
          f"solve that seeds them) in {sec * 1e3:.1f} ms, {sec / FIT_BINARY_STEPS * 1e3:.1f} "
          f"ms a step, losses {losses.tolist()}, [kij, eps_AiBj] {res.parameters.tolist()}, "
          f"phi_d2 launches {launches}")
    check(launches == 0, "fit_binary launched phi_d2")
    check(bool(np.isfinite(losses).all()) and bool(np.all(np.diff(losses) < 0.0)),
          "fit_binary loss does not fall")
    for what, a, b in (("loss history", card.loss_history, on_cpu.loss_history),
                       ("[kij, eps_AiBj]", card.parameters, on_cpu.parameters)):
        no = torch.zeros(b.shape, dtype=torch.bool)
        agree(f"fit_binary {what}", no, a.cpu(), no, b, 1e-8)
    return {"launches": launches, "by_k": {}, "ms_per_step": sec / FIT_BINARY_STEPS * 1e3,
            "steps": FIT_BINARY_STEPS, "losses": losses.tolist()}


def closes(label, dew, temperature, y1, pressure):
    """The dew curve closes: a dew solve at (T, y1) returns the diagram's
    pressure within 1e-8."""
    with torch.no_grad():
        p, nans = dew(temperature, torch.stack([y1, 1.0 - y1], 1), pressure)
    rel = float((p / pressure - 1.0).abs().max())
    print(f"  {label}: dew pressure at (T, y1) against the diagram's, max rel err {rel:.3e} "
          f"(bound 1e-8)")
    check(not bool(nans.any()) and rel <= 1e-8, f"{label}: the dew curve does not close")


def diagrams(dev):
    """Phase 14(d): p-x-y at 150 K and T-x-y at 1e5 Pa of config 3's pair
    and of the non-associating pair, and the gc diagrams of config 4 at
    300 K and 3e5 Pa, at DIAGRAM_POINTS points, each with its phi_d2
    launches by k (the pure seeds) and the closure of its dew curve."""
    paths = {}
    n = DIAGRAM_POINTS
    for pair, system, kij in (("config 3", CONFIG3, CONFIG3_KIJ),
                              ("non-associating", NONASSOC, NONASSOC_KIJ)):
        batch = f64(np.tile(system, (n, 1, 1)), dev)
        kb = f64(np.tile(kij, (n, 1)), dev)
        dew = partial(dew_point, batch, kb)
        for kind, fn, arg in (("p-x-y", binary_pxy, 150.0), ("T-x-y", binary_txy, 1e5)):
            label = f"{pair} {kind}"
            with torch.no_grad():
                d, sec, launches, by_k = on_card(lambda: fn(system, kij, arg, n, device=dev))
            paths[label] = report(14, label, d.nans, sec, launches, by_k)
            check(launches > 0, f"{label}: the pure seeds launched no phi_d2")
            check(not bool(d.nans.any()), f"{label}: failed rows")
            if kind == "p-x-y":
                closes(label, dew, torch.full_like(d.p, arg), d.y1, d.p)
            else:
                closes(label, dew, d.t, d.y1, torch.full_like(d.t, arg))
    model = GcSystem(n).model(dev)
    for kind, fn, arg in (("p-x-y", gc_binary_pxy, 300.0), ("T-x-y", gc_binary_txy, 3e5)):
        label = f"gc config 4 {kind}"
        with torch.no_grad():
            d, sec, launches, by_k = on_card(lambda: fn(model, arg, n_points=n))
        paths[label] = report(14, label, d.nans, sec, launches, by_k)
        check(launches == 0 and not bool(d.nans.any()), f"{label}: launches or failed rows")
        if kind == "p-x-y":
            closes(label, model.dew_point, torch.full_like(d.p, arg), d.y1, d.p)
        else:
            closes(label, model.dew_point, d.t, d.y1, torch.full_like(d.t, arg))
    return paths


def property_floors(props, temperature, rho, stiff):
    """Per field, the f64 noise of the liquid p~ (P_NOISE times the ray
    stiffness rho dp~/drho) times the field's sensitivity to p~; see
    :func:`residual_properties`."""
    noise = P_NOISE * stiff
    to_pa = temperature * REDUCED_TO_PA_PER_KT
    rho_t = rho.sum(-1)
    rt = RGAS * temperature
    x = props.c_p_res / RGAS - props.c_v_res / RGAS + 1.0
    return {
        "pressure": to_pa * noise,
        "compressibility": noise / rho_t,
        "h_res": rt * noise / rho_t,
        "g_res": rt * noise / rho_t,
        "c_p_res": RGAS * 2.0 * torch.sqrt(x.abs() / (rho_t * stiff)) * noise,
        "ln_phi": (noise / (props.pressure / to_pa).abs())[:, None],
    }


def ray_stiffness(helmholtz, temperature, rho):
    """rho dp~/drho along the composition ray, rho_t + d2A/dV2 at V = 1,
    from ``helmholtz(T, rho) -> phi``."""
    _, _, _, _, a_vv = state_derivatives(partial(helmholtz, temperature), rho)
    return rho.sum(-1) + a_vv


@torch.no_grad()
def property_case(label, properties, helmholtz, properties_cpu, temperature, z, state):
    """Phase 14(e), one model: the property set at its converged bubble
    states, liquid and vapor; isofugacity across the phases within 1e-8
    plus the liquid p~'s f64 floor; the first N_CPU rows of each phase
    against the CPU at 1e-10 plus the same floors.  ``properties(T, rho)``
    and ``helmholtz(T, rho)`` are the model's on the card,
    ``properties_cpu(T, rho)`` its first N_CPU rows' on the CPU."""
    rows = len(temperature)
    phases = {"liquid": z * torch.exp(state[:, 2:3]), "vapor": torch.exp(state[:, :2])}
    out, sec, launches, _ = on_card(
        lambda: {name: properties(temperature, rho) for name, rho in phases.items()})
    path = report(14, f"{label} (liquid and vapor)", torch.zeros(2 * rows, dtype=torch.bool),
                  sec, launches, {})
    check(launches == 0, f"{label}: launched phi_d2")
    floors = {name: property_floors(out[name], temperature, rho,
                                    ray_stiffness(helmholtz, temperature, rho))
              for name, rho in phases.items()}
    for name, props in out.items():
        for field_name, field in zip(ResidualProperties._fields, props):
            check(bool(torch.isfinite(field).all()), f"{label} {name} {field_name} not finite")
    y = phases["vapor"] / phases["vapor"].sum(-1, keepdim=True)
    err = (torch.log(z) + out["liquid"].ln_phi - torch.log(y) - out["vapor"].ln_phi).abs()
    allowed = 1e-8 + floors["liquid"]["ln_phi"] + floors["vapor"]["ln_phi"]
    worst = float((err / allowed).max())
    print(f"  {label} isofugacity on {rows} rows: max |ln x_i phi_i,L - ln y_i phi_i,V| "
          f"{float(err.max()):.3e}, max err / (1e-8 + p~ floors) {worst:.3e}")
    check(worst <= 1.0, f"{label}: isofugacity")
    n = N_CPU
    for name, rho in phases.items():
        on_cpu = properties_cpu(temperature[:n].cpu(), rho[:n].cpu())
        for field_name, field, cpu_field in zip(ResidualProperties._fields, out[name],
                                                on_cpu):
            got = field[:n].cpu()
            floor = floors[name].get(field_name)
            floor = None if floor is None else floor[:n].cpu().expand_as(got)
            no = torch.zeros(got.shape, dtype=torch.bool)
            agree(f"{label} {name} {field_name}", no.flatten(), got.flatten(),
                  no.flatten(), cpu_field.flatten(),
                  1e-10, None if floor is None else floor.flatten())
    return path


def properties_phase(mix_states, gc_states):
    """Phase 14(e): mixture properties at the 100,000 converged config 3
    bubble states of 14(a) and gc properties at config 4's of 14(b)."""
    params, kij, temperature, x1, state = mix_states
    z = torch.stack([x1, 1.0 - x1], 1)
    n = N_CPU
    paths = {"mix_properties": property_case(
        "mix_properties config 3", partial(mix_properties, params, kij),
        partial(mix_helmholtz_energy_density, params, kij),
        partial(mix_properties, params[:n].cpu(), kij[:n].cpu()), temperature, z, state)}
    model, temperature, x1, state = gc_states
    g = model.params.detach()
    g_cpu = GcSystem(n).model("cpu", n).params.detach()
    paths["gc_properties"] = property_case(
        "gc_properties config 4", partial(gc_properties, g),
        partial(gc_helmholtz_energy_density, g), partial(gc_properties, g_cpu), temperature,
        torch.stack([x1, 1.0 - x1], 1), state)
    return paths


def config6(rows, dev):
    """Config 6 of benchmarks/run_all.py on ``rows`` rows: ``(params, kij, T,
    x1, p)`` with p the log-midpoint of the port's own bubble and dew
    pressures."""
    params = f64(np.tile(CONFIG3, (rows, 1, 1)), dev)
    kij = f64(np.tile(CONFIG3_KIJ, (rows, 1)), dev)
    temperature = f64(np.linspace(140.0, 160.0, rows), dev)
    x1 = f64(np.full(rows, 0.5), dev)
    p0 = f64(np.full(rows, 1e5), dev)
    with torch.no_grad():
        p_bub, nb = bubble_point(params, kij, temperature, x1, p0)
        p_dew, nd = dew_point(params, kij, temperature, x1, p0)
    check(not bool((nb | nd).any()), f"config 6 edges at B={rows}")
    return params, kij, temperature, x1, torch.sqrt(p_bub * p_dew)


def gc_config4_flash(rows, dev):
    """Config 4 on ``rows`` rows with its mid-window pressures: ``(system,
    model on dev, T, x1, p)``."""
    system = GcSystem(rows)
    model = system.model(dev)
    temperature = f64(np.linspace(140.0, 160.0, rows), dev)
    x1 = f64(np.full(rows, 0.5), dev)
    p0 = f64(np.full(rows, 1e5), dev)
    with torch.no_grad():
        p_bub, nb = model.bubble_point(temperature, x1, p0)
        p_dew, nd = model.dew_point(temperature, x1, p0)
    check(not bool((nb | nd).any()), f"gc config 4 edges at B={rows}")
    return system, model, temperature, x1, torch.sqrt(p_bub * p_dew)


def flash_rates(label, run, rows, p):
    """Phase 15(a, c): a flash path's first call with its loop counts, then
    the median of FLASH_REPS synchronised calls, each at p varied by 1e-9
    relative (as run_all.py::config6 does); ``run(p, stats=None)`` returns
    the flash's outputs.  Checks that no call launched phi_d2 and that every
    row split in two phases, as the C++ oracle splits them.  Returns the
    first call's outputs and the path's record."""
    stats = {}
    out, sec, launches, _ = on_card(lambda: run(p, stats=stats))
    times = []
    for rep in range(FLASH_REPS):
        _, t, n, _ = on_card(lambda: run(p * (1.0 + 1e-9 * (rep + 1))))
        times.append(t)
        launches += n
    step = statistics.median(times)
    n_two = int((out[4] == 2).sum())
    print(f"phase 15 {label}: two-phase {n_two} of {rows}, first call {sec * 1e3:.1f} ms, "
          f"median {step * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} ms "
          f"({n_two / step:.1f} splits/s), loops {stats}, phi_d2 launches {launches}")
    check(launches == 0, f"{label}: the path launched phi_d2")
    check(n_two == rows, f"{label}: {n_two} of {rows} rows split (the oracle splits all)")
    return out, {"launches": launches, "by_k": {}, "ms": step * 1e3, "first_ms": sec * 1e3,
                 "two_phase": n_two, "rows": rows, "loops": stats}


@torch.no_grad()
def flash_consistency(label, properties, temperature, x1, p, out):
    """tests/test_flash.py's checks on every row: material balance within
    1e-9 and, through the model's residual properties ``properties(T,
    rho)``, the liquid's p within 1e-8 plus its p~ floor, the vapor's within
    1e-8, and isofugacity within 1e-7 plus the floor's share of p."""
    beta, x, y, rho, _ = out
    z = torch.stack([x1, 1.0 - x1], 1)
    balance = float((beta[:, None] * y + (1.0 - beta[:, None]) * x - z).abs().max())
    props_l = properties(temperature, x * rho[:, :1])
    props_v = properties(temperature, y * rho[:, 1:])
    noise = FLASH_P_NOISE * temperature * REDUCED_TO_PA_PER_KT
    p_l = float(((props_l.pressure - p).abs() / (1e-8 * p + noise)).max())
    p_v = float(((props_v.pressure - p).abs() / (1e-8 * p)).max())
    f_l = x * torch.exp(props_l.ln_phi)
    f_v = y * torch.exp(props_v.ln_phi)
    fug = float(((f_l - f_v).abs() / ((1e-7 + noise / p)[:, None] * f_v.abs())).max())
    print(f"  {label}: max |beta y + (1 - beta) x - z| {balance:.3e} (bound 1e-9); max err / "
          f"allowed: liquid p {p_l:.3e}, vapor p {p_v:.3e}, isofugacity {fug:.3e}")
    check(balance <= 1e-9 and max(p_l, p_v, fug) <= 1.0, f"{label}: flash consistency")


def flash_agree(label, card, on_cpu):
    """The card's flash against the CPU's on the same rows: equal phase
    codes, beta, x and y within 1e-10, rho within rtol 1e-10."""
    n = len(on_cpu[4])
    card = [o[:n].cpu() for o in card]
    check(torch.equal(card[4], on_cpu[4]), f"{label}: card and CPU phase codes differ")
    for name, i, rtol, floor in (("beta", 0, 0.0, 1e-10), ("x", 1, 0.0, 1e-10),
                                 ("y", 2, 0.0, 1e-10), ("rho", 3, 1e-10, None)):
        got, want = card[i].flatten(), on_cpu[i].flatten()
        no = torch.zeros(got.shape, dtype=torch.bool)
        agree(f"{label} {name}", no, got, no, want, rtol, floor)


def flash_grad_run(flash_fn, leaves, x1):
    """``flash_fn()``, a flash with ``gradients=True``, and the backward of
    sum beta + sum x1 + sum ln rho_L over the two-phase rows into ``leaves``
    (tensors that require a gradient, the feed ``x1`` among them).  Returns the outputs,
    the gradients, and d(sum beta)/dx1 and d(sum x1 + y1 + ln rho_L + ln
    rho_V)/dx1 (by the phase rule, the lever rule 1/(y1 - x1) and 0)."""
    beta, x, y, rho, phase = flash_fn()
    failed = phase != 2
    (lever,) = torch.autograd.grad(masked_sum(beta, failed), x1, retain_graph=True)
    rest = masked_sum(x[:, 0] + y[:, 0] + torch.log(rho).sum(-1), failed)
    (zero,) = torch.autograd.grad(rest, x1, retain_graph=True)
    masked_sum(beta + x[:, 0] + torch.log(rho[:, 0]), failed).backward()
    out = tuple(o.detach() for o in (beta, x, y, rho, phase))
    return out, [g.grad for g in leaves], (lever, zero)


def timed_flash_grad(label, run, rows, out):
    """Phase 15(b, c): one call of ``run()`` (:func:`flash_grad_run`) on the
    card.  Checks that it launched no phi_d2, split every row, gave finite
    gradients and the outputs ``out`` of the call without gradients bit for
    bit, and held the phase rule.  Returns its outputs, its gradients and
    the path's record."""
    (out_g, grads, anchors), sec, launches, _ = on_card(run)
    n_two = int((out_g[4] == 2).sum())
    print(f"phase 15 {label}: two-phase {n_two} of {rows}, one call with backward "
          f"{sec * 1e3:.1f} ms ({n_two / sec:.1f} splits+gradients/s), phi_d2 launches "
          f"{launches}")
    check(launches == 0 and n_two == rows, f"{label}: launches or split rows")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    for a, b in zip(out_g, out):
        check(torch.equal(a, b), f"{label}: gradients=True changed an output")
    phase_rule(label, out_g, anchors)
    return out_g, grads, {"launches": launches, "by_k": {}, "ms": sec * 1e3,
                          "two_phase": n_two, "rows": rows}


def phase_rule(label, out, anchors):
    """dbeta/dz1 = 1/(y1 - x1) within 1e-6 and d{x, y, rho}/dz1 = 0 within
    1e-6 on every row."""
    _, x, y, _, _ = out
    lever, zero = anchors
    rel = float((lever * (y[:, 0] - x[:, 0]) - 1.0).abs().max())
    worst = float(zero.abs().max())
    print(f"  {label}: max |dbeta/dz1 (y1 - x1) - 1| {rel:.3e}, max |d(x1 + y1 + ln rho)/dz1| "
          f"{worst:.3e} (bounds 1e-6)")
    check(rel <= 1e-6 and worst <= 1e-6, f"{label}: phase-rule anchors")


def mix_flash_grad(params, kij, temperature, x1, p):
    leaves = [a.detach().requires_grad_() for a in (params, kij, temperature, x1, p)]
    pa, ka, ta, za, pp = leaves
    return flash_grad_run(lambda: flash(pa, ka, ta, za, pp, gradients=True), leaves, za)


def gc_flash_grad(model, temperature, x1, p):
    model.zero_grad(set_to_none=True)
    za, pp = x1.detach().requires_grad_(), p.detach().requires_grad_()
    leaves = [model.parameter, model.kab, model.phi, za, pp]
    return flash_grad_run(lambda: model.flash(temperature, za, pp, gradients=True), leaves, za)


def mixture_flash(dev):
    """Phase 15(a, b, d): config 6 at FLASH_SIZES without gradients (first
    call, median, consistency, 512 rows on the CPU), with gradients at
    FLASH_GRAD_ROWS (anchors, 512 rows on the CPU), and the profile of the
    largest call."""
    paths, times = {}, {}
    for rows in FLASH_SIZES:
        t0 = time.perf_counter()
        params, kij, temperature, x1, p = config6(rows, dev)
        label = f"config 6 flash B={rows}"

        def run(pv, stats=None):
            with torch.no_grad():
                return flash(params, kij, temperature, x1, pv, stats=stats)

        out, paths[label] = flash_rates(label, run, rows, p)
        flash_consistency(label, partial(mix_properties, params, kij), temperature, x1, p, out)
        n = N_CPU_FLASH
        with torch.no_grad():
            on_cpu = flash(*(a[:n].cpu() for a in (params, kij, temperature, x1, p)))
        flash_agree(label, out, on_cpu)
        times[f"(a) B={rows}"] = time.perf_counter() - t0

        if rows == FLASH_GRAD_ROWS:
            t0 = time.perf_counter()
            label = f"config 6 flash with gradients B={rows}"
            args = (params, kij, temperature, x1, p)
            out_g, grads, paths[label] = timed_flash_grad(
                label, lambda: mix_flash_grad(*args), rows, out)
            c_out, c_grads, _ = mix_flash_grad(*(a[:n].cpu() for a in args))
            flash_agree(label, out_g, c_out)
            agree_gradients(label, ("params", "kij", "T", "x1", "p"),
                            (g[:n] for g in grads), c_grads)
            times["(b)"] = time.perf_counter() - t0
        if rows == FLASH_SIZES[-1]:
            t0 = time.perf_counter()
            profile(15, f"config 6 flash B={rows}", lambda: run(p),
                    paths[f"config 6 flash B={rows}"], what="no gradient")
            times["(d)"] = time.perf_counter() - t0
    return paths, times


def gc_flash_phase(dev):
    """Phase 15(c): gc config 4 at FLASH_GRAD_ROWS, without gradients (first
    call, median, consistency) and with them (anchors), each with its first
    N_CPU_FLASH rows on the card and on the CPU."""
    rows, n = FLASH_GRAD_ROWS, N_CPU_FLASH
    system, model, temperature, x1, p = gc_config4_flash(rows, dev)
    label = f"gc config 4 flash B={rows}"

    def run(pv, stats=None):
        with torch.no_grad():
            return model.flash(temperature, x1, pv, stats=stats)

    paths = {}
    out, paths[label] = flash_rates(label, run, rows, p)
    g = model.params.detach()
    flash_consistency(label, partial(gc_properties, g), temperature, x1, p, out)
    cpu_model = system.model("cpu", n)
    cpu_args = [a[:n].cpu() for a in (temperature, x1, p)]
    with torch.no_grad():
        flash_agree(label, out, cpu_model.flash(*cpu_args))

    label = f"gc config 4 flash with gradients B={rows}"
    _, _, paths[label] = timed_flash_grad(
        label, lambda: gc_flash_grad(model, temperature, x1, p), rows, out)
    # the segment gradients are shared by the rows: the same N rows on both
    card = gc_flash_grad(system.model(dev, n), *(a[:n] for a in (temperature, x1, p)))
    on_cpu = gc_flash_grad(cpu_model, *cpu_args)
    flash_agree(label, card[0], on_cpu[0])
    agree_gradients(label, ("segment parameters", "k_ab", "phi", "x1", "p"), card[1],
                    on_cpu[1])
    return paths


def main():
    start = time.perf_counter()
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
    launches, by_k, nans_vp, p_sat = main_path(dev, params, temperature, power)

    # phases 6-10: the rest of the pure-component surface on the same rows
    paths = {"vapor_pressure": {"launches": launches,
                                "by_k": {str(k): n for k, n in sorted(by_k.items())}}}
    nans_l, rho_l, liquid_paths = liquid_densities(params, temperature, p_sat)
    paths.update(liquid_paths)
    paths["critical_point"] = critical_points(params)
    paths["boiling_temperature"] = boiling_temperatures(params, temperature, p_sat, nans_vp)
    paths["pure_properties"] = residual_properties(params, temperature, p_sat, nans_l, rho_l)
    paths["fit_pure"] = fit(params_np, temperature, p_sat, rho_l)

    # phases 11-12: binary mixtures (torch ops only: no phi_d2 launch)
    paths["mix_derivatives"] = mixture_derivatives(dev)
    paths.update(mixtures(dev))

    # phase 13: gc-PC-SAFT (torch ops only: no phi_d2 launch)
    paths["gc_derivatives"] = gc_derivative_set(dev)
    paths.update(gc_mixtures(dev))

    # phase 14: the binary workload on bubble and dew points (torch ops; the
    # diagrams' pure seeds launch phi_d2)
    t14 = time.perf_counter()
    mix_paths, fit_data, mix_states = mixture_temperatures(dev)
    paths.update(mix_paths)
    t14b = time.perf_counter()
    gc_paths, gc_states = gc_temperatures(dev)
    paths.update(gc_paths)
    t14c = time.perf_counter()
    paths["fit_binary"] = binary_fit(dev, fit_data)
    t14d = time.perf_counter()
    paths.update(diagrams(dev))
    t14e = time.perf_counter()
    paths.update(properties_phase(mix_states, gc_states))
    done = time.perf_counter()
    print(f"phase 14: {done - t14:.1f} s: (a) {t14b - t14:.1f}, (b) {t14c - t14b:.1f}, "
          f"(c) {t14d - t14c:.1f}, (d) {t14e - t14d:.1f}, (e) {done - t14e:.1f}")

    # phase 15: the isothermal pT flash (torch ops: no phi_d2 launch)
    t15 = time.perf_counter()
    flash_paths, times = mixture_flash(dev)
    paths.update(flash_paths)
    t15c = time.perf_counter()
    paths.update(gc_flash_phase(dev))
    done = time.perf_counter()
    times["(c)"] = done - t15c
    print(f"phase 15: {done - t15:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(times.items())))
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s from the start of main")

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
        "launches_by_path": paths,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
