"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout and holds
each against its plain PyTorch version, timed beside its bound (phase 3):
the variant of phi_d2 each of the solver's density shapes launches, the
pure_vle kernels (the whole pure VLE solve: a spinodal scan with 16 threads
a row, then a solve with one thread a row; each stage also timed alone)
against ``pure_vle_plain`` and the vp_identity kernel (the vapor-pressure
identity and its 9 partials by a hand-written adjoint) against autograd of
its plain graph, both on 100,000 ``make_batch`` rows, with the registers,
spills and resident warps an SM of each of these kernels.  It checks the README anchors through both kernels,
then drives the main path at full size: vapor pressures of a 100,000-row
``make_batch`` with reverse-mode gradients with respect to all 8
parameters of every row, one pure_vle and one vp_identity launch and no
phi_d2 launch, held to its torch-ops twin on the card, with a profile of
the step (phase 5).  Phases 6-10 drive the rest of the
pure-component surface on the same rows, each with its kernel launches:
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
dew points, torch ops but for the diagrams' pure seeds (``pure_vle``): bubble
and dew temperatures of config 3 and of config 4 at 4,096 and 100,000 rows
(the golden topologies at 512) at the port's own pressures, with gradients,
the implicit-function identity and 512 rows on the CPU; three
``fit_binary`` steps; p-x-y and T-x-y diagrams with the closure of their
dew curves; and the residual properties of config 3's and config 4's
100,000 coexisting phases, with isofugacity and 2,000 rows on the CPU.
Phases 12-15 time each cell as its first call and the median of 2 more.
Phase 15 drives the isothermal pT flash, torch ops only: config 6 of
``benchmarks/run_all.py`` (config 3's pair at the log-midpoint of its
bubble and dew pressures) at 4,096 and 100,000 rows, timed as run_all.py
times it, with material balance, isobaric closure and isofugacity through
``mix_properties`` and 512 rows on the CPU; the same with gradients at
4,096 rows, held to the phase rule (dbeta/dz1 = 1/(y1 - x1), dx/dz1 = 0)
and to the CPU; and gc config 4 at 4,096 rows without and with gradients.
Phase 16 drives the n-component paths on ternaries, torch ops only: (a)
the non-associating ternary of ``tests/test_multicomponent.py``, (b) config
3's cross-associating pair with an inert placed first, held row by row to
the same solve in the order [A, B, inert], and (c) gc
butane/propane/pentane, bubble and dew with the gradient of sum ln p at
4,096 and 100,000 rows (first call, median of 2, 512 rows on the CPU, dew
below bubble); bubble temperatures, flashes without and with gradients
(material balance, isofugacity) of (a) and (c) at 4,096 rows and the
properties of (a)'s 100,000 bubble states; the trace dilution of (a) to
its binary; a ValueError for three associating components; and the
profile of (a)'s 100,000-row bubble call.  Phase 17 drives data
parallelism (``feos_tpu_torch/parallel``) as one rank of an NCCL group on
this card: phase 10's ``fit_pure`` with a mesh, held to phase 10 within
1e-12; two ``fit_binary`` steps of phase 14's rows with and without a mesh,
held to each other; and ``data_parallel(vapor_pressure)`` on phase 5's
rows padded with NaN rows, held to phase 5.  Phase 18 runs the six
examples of ``examples_torch/`` on the card (the fits at a few steps, whose
losses must fall; the diagrams, whose dew curves must close).  Phase 19
checks the port's tracer on the steps of the benchmark's pure_vp.b100k and
pure_fit.b100k cells: under ``torch.profiler`` its spans change no device
event, aten op or sync and are no device event, the pure_vle kernel's phi
evaluations a row it keeps equal ``iters[:, 2]`` read directly, and each
step and each profiled window is timed with the tracer off and on in
turns.  Every phase raises on failure; the seconds of each phase are
printed at the end.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; the line before it lists each kernel with
its launches on the main path, its error against the plain version, its
times and its bound.  Without CUDA the script exits nonzero and prints no
result.
"""

import ctypes
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import tempfile
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
    pure_derivatives, pure_properties, pure_vle, tracing, vapor_pressure,
)
from feos_tpu_torch.kernels import build
from feos_tpu_torch.kernels import pure_vle as pure_vle_kernel
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error, phi_d2, phi_d2_plain
from feos_tpu_torch.kernels.vp_identity import identity_plain, vp_identity, vp_identity_plain
from feos_tpu_torch.ops.derivatives import state_derivatives
from feos_tpu_torch.parallel import (
    all_reduce_sum, batch_mesh, data_parallel, initialize_multi_host, pad_to_multiple,
)
from feos_tpu_torch.solvers.vle import _ETA_GRID, pure_vle_plain
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
# pure_vle: a row's phi evaluations (the kernel counts them) at the
# operations above, and its bytes: 8 parameters and T in; rho_V, rho_L, the
# mask and three int32 counters out; the 48 grid points once
BYTES_VLE_ROW = 72 + 16 + 1 + 12
PURE_VLE_RTOL = 1e-10    # rho_V, rho_L of the kernel against pure_vle_plain
# f64 operations vp_identity needs a row: p~ and its 9 partials by the
# adjoint, tallied without the operations on exact zeros by
# csrc/vp_identity_ops.cpp: a non-polar, non-associating row; what a dipole
# and the two-site association add (fewer where na = nb, whose rho_a - rho_b
# is 0); and what a row with m > 2 saves (mc = 2 there: md2 is 0, and md1's
# and md2's adjoints stop at mc).  tests/test_torch_vp_identity_kernel.py
# holds vp_identity_ops() to the tally of the header row by row.
OPS_VP_ROW = 630
OPS_VP_DIPOLE = 384
OPS_VP_ASSOC = 173
OPS_VP_ASSOC_SYMMETRIC = 151
OPS_VP_SAVED_M2 = 4
OPS_VP_SAVED_M2_DIPOLE = 52
# bytes vp_identity must move a row: 8 parameters, T, rho_V, rho_L in; p~
# and 9 partials out
BYTES_VP_ROW = 21 * 8
VP_RTOL = 1e-12          # p~ of the kernel against the plain graph
PARTIALS_BOUND = 1e-10   # max_scaled_error of the partials and gradients
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
MIX_REPS = 2
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
FLASH_REPS = 2
FLASH_GRAD_ROWS = 4_096
N_CPU_FLASH = 512
FLASH_P_NOISE = 2e-14
# phase 16: n-component mixtures.  (a) the non-associating ternary of
# tests/test_multicomponent.py; (b) config 3's cross-associating pair with an
# inert placed first, so that the association terms gather the pair from
# slots 1 and 2; (c) gc butane/propane/pentane with k_ab(CH3, CH2) = 0 (a
# gradient in it) and phi = 1
TERNARY = [[1.0, 3.5, 150, 0, 0, 0, 0, 0], [1.6, 3.6, 180, 0, 0, 0, 0, 0],
           [2.3, 3.7, 222, 0, 0, 0, 0, 0]]
TERNARY_Z = [0.3, 0.3, 0.4]
INERT = [1, 3.5, 175, 0, 0, 0, 0, 0]
CROSS_TERNARY = [INERT] + CONFIG3   # [inert, A, B]
CROSS_Z = [0.2, 0.4, 0.4]
JAX_ORDER = [1, 2, 0]               # [A, B, inert]: the pair in slots 0 and 1
GC_TERNARY_SEGMENTS = [["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"],
                       ["CH3", "CH2", "CH2", "CH2", "CH3"]]
GC_TERNARY_BONDS = [[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]],
                    [[0, 1], [1, 2], [2, 3], [3, 4]]]
GC_TERNARY_KAB = [("CH3", "CH2", 0.0)]
TERNARY_SIZES = (4_096, 100_000)
TERNARY_ROWS = 4_096                # the further paths of 16(d)
N_CPU_TERNARY = 512
TRACE_Z = [0.4 - 5e-9, 0.6 - 5e-9, 1e-8]
TRACE_RTOL = 1e-7
# phase 17: data parallelism on one card
DP_STEPS = 2                        # fit_binary steps with and without the mesh
DP_PAD = 1_024                      # phase 5's rows padded to a multiple of this
# phase 18: the examples, and the steps of each fit
EXAMPLES = ("fit_parameters", "fit_binary_kij", "fit_gc_kab", "fit_flash_kij", "pxy_diagram",
            "txy_diagram")
EXAMPLE_STEPS = {"fit_parameters": 3, "fit_binary_kij": 2, "fit_gc_kab": 2, "fit_flash_kij": 2}
# phase 19: the tracer; for each benchmark step, the steps of a profiled
# window and the groups of four timed steps (off, on, on, off)
TRACE_STEPS = {"pure_vp": (5, 60), "pure_fit": (2, 15)}
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
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
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
    m = re.search(r"\d(phi_d2_[a-z]+|pure_vle_[a-z]+|vp_identity_kernel)", mangled)
    return m.group(1) if m else mangled


def resources(log):
    """``{kernel: {"registers", "stack", "spill_stores", "spill_loads"}}``
    from nvcc's ``--resource-usage`` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


# the main path's kernels: registers from nvcc's report, resident blocks an
# SM from the library (128 threads a block, 4 warps)
MAIN_KERNELS = ("pure_vle_scan", "pure_vle_solve", "vp_identity_kernel")
MIN_SOLVE_WARPS = 16


def main_kernel_resources(log):
    """Registers, stack frame, spills and resident blocks and warps an SM of
    each of MAIN_KERNELS; none may spill or keep a stack frame, and the
    pure_vle solve must keep MIN_SOLVE_WARPS warps an SM."""
    lib = build.library()
    blocks, vp_blocks = (ctypes.c_int * 2)(), (ctypes.c_int * 1)()
    check(lib.feos_pure_vle_occupancy(0, blocks) == 0, "pure_vle occupancy query failed")
    check(lib.feos_vp_identity_occupancy(0, vp_blocks) == 0,
          "vp_identity occupancy query failed")
    res = resources(log)
    out = {}
    for name, n in zip(MAIN_KERNELS, (blocks[0], blocks[1], vp_blocks[0])):
        out[name] = {**res[name], "blocks_per_sm": n, "warps_per_sm": 4 * n}
        r = out[name]
        print(f"  {name}: {r['registers']} registers, {r['stack']} bytes stack frame, "
              f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads; "
              f"{n} blocks = {4 * n} warps an SM")
        check(r["stack"] == 0 and r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"{name} keeps a stack frame or spills")
    check(out["pure_vle_solve"]["warps_per_sm"] >= MIN_SOLVE_WARPS,
          f"the pure_vle solve keeps fewer than {MIN_SOLVE_WARPS} warps an SM")
    return out


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


def bound_of(ops, nbytes):
    """``(bound_ms, bound_by)``: the larger of the f64 operations over the
    f64 peak and the bytes over the memory rate."""
    t_ops, t_bytes = float(ops) / PEAK_F64_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound(params, temperature, k):
    """``bound_of`` what ``phi_d2`` must do for these rows at k."""
    return bound_of(*work(params, temperature, k))


@torch.no_grad()
def vle_work(params, temperature, iters):
    """``(ops, bytes)`` that ``pure_vle`` must do and move for these rows:
    each row's phi evaluations (the kernel's counter, ``iters[:, 2]``) at
    phi_d2's operations for the row's terms, and its row stage once; each
    input read once, each output written once."""
    pre = precompute_pure(PureParams.from_tensor(params), temperature)
    associating = pre.delta_t != 0.0
    per_eval = (OPS_ELEMENT + (pre.mu2eff != 0.0) * OPS_DIPOLE
                + torch.where(pre.na == pre.nb, OPS_ASSOC_SYMMETRIC, OPS_ASSOC) * associating)
    B = params.shape[0]
    ops = B * OPS_ROW + int((iters[:, 2].long() * per_eval).sum())
    return ops, B * BYTES_VLE_ROW + len(_ETA_GRID) * 8


def vp_identity_ops(params):
    """The f64 operations ``vp_identity`` needs for each row, ``(B,)``: the
    OPS_VP_* counts of the row's terms.  The association term runs where
    kappa_ab or eps_ab is not 0 (its partials are not 0 there); a row with
    only one of them 0 (none in make_batch) needs fewer than counted."""
    m, mu, kappa_ab, eps_ab, na, nb = (params[:, j] for j in (0, 3, 4, 5, 6, 7))
    dipolar = (mu != 0.0).long()
    assoc = torch.where(na == nb, OPS_VP_ASSOC_SYMMETRIC, OPS_VP_ASSOC)
    return (OPS_VP_ROW + dipolar * OPS_VP_DIPOLE
            + assoc * ((kappa_ab != 0.0) | (eps_ab != 0.0))
            - (m > 2.0).long() * (OPS_VP_SAVED_M2 + dipolar * OPS_VP_SAVED_M2_DIPOLE))


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


def pure_vle_stages(params, temperature):
    """``(scan, solve)``: callables that launch one of the pure_vle kernels'
    two stages alone, on buffers of their own, the solve on the scan's
    result; for timing each stage.  Not counted as launches."""
    lib = build.library()
    B, dev = len(temperature), temperature.device
    grid = f64(_ETA_GRID, dev)
    spinodal = torch.empty((B, 3), dtype=torch.float64, device=dev)
    outs = (torch.empty(B, dtype=torch.float64, device=dev),
            torch.empty(B, dtype=torch.float64, device=dev),
            torch.empty(B, dtype=torch.bool, device=dev),
            torch.empty((B, 3), dtype=torch.int32, device=dev))

    def run(stages):
        err = lib.feos_pure_vle(params.data_ptr(), temperature.data_ptr(), grid.data_ptr(),
                                spinodal.data_ptr(), *(o.data_ptr() for o in outs), B, stages,
                                dev.index, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"pure_vle stage {stages} launch failed: cudaError {err}")

    run(1)
    return (lambda: run(1)), (lambda: run(2))


def pure_vle_vs_plain(params, temperature):
    """Phase 3: the pure_vle kernel against pure_vle_plain on the card
    (which launches phi_d2) on phase 5's rows: equal masks, rho_V and rho_L
    within PURE_VLE_RTOL; both loops' iteration maxima; the per-row counts;
    times in turns beside the bound.  Returns its record and the kernel's
    (rho_v, rho_l, ok)."""
    stats = {}
    want = pure_vle_plain(params, temperature, stats=stats)
    rho_v, rho_l, ok, iters = pure_vle_kernel.launch(params, temperature)
    torch.cuda.synchronize()
    check(torch.equal(ok, want[2]),
          f"pure_vle: kernel and plain masks differ on {int((ok != want[2]).sum())} rows")
    rel = max(float((a / b - 1.0).abs()[ok].max()) for a, b in zip((rho_v, rho_l), want))
    abs_err = max(float((a - b).abs()[ok].max()) for a, b in zip((rho_v, rho_l), want))
    npt, newton, evals = iters.T.long()
    # a warp runs its slowest row: the evaluations its 32 rows did against
    # 32 times its largest
    warps = evals[: len(evals) // 32 * 32].view(-1, 32)
    lanes = float(warps.sum() / (32 * warps.max(1).values.sum()))
    print(f"pure_vle vs plain (B={len(ok)}): masks equal ({int(ok.sum())} converged), max rel "
          f"err rho {rel:.3e} (rtol {PURE_VLE_RTOL:g}), max abs err {abs_err:.3e}; kernel "
          f"maxima npt {int(npt.max())}, newton {int(newton.max())}; plain loops npt "
          f"{stats['npt']}, newton {stats['newton']}")
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=evals.device)
    print(f"  per-row counts (median, 90%, 99%, max): npt "
          f"{torch.quantile(npt.double(), q).tolist()}, newton "
          f"{torch.quantile(newton.double(), q).tolist()}, phi evaluations "
          f"{torch.quantile(evals.double(), q).tolist()}, mean {float(evals.double().mean()):.2f}; "
          f"lanes busy in a warp {lanes:.3f}")
    check(rel <= PURE_VLE_RTOL, "pure_vle kernel off pure_vle_plain")
    # in turns: plain, kernels, scan, solve, solve, scan, kernels, plain
    scan, solve = pure_vle_stages(params, temperature)
    plain_1 = cuda_ms(lambda: pure_vle_plain(params, temperature), 2)
    kern_1 = cuda_ms(lambda: pure_vle_kernel.launch(params, temperature), 10)
    scan_1, solve_1 = cuda_ms(scan, 10), cuda_ms(solve, 10)
    solve_2, scan_2 = cuda_ms(solve, 10), cuda_ms(scan, 10)
    kern_2 = cuda_ms(lambda: pure_vle_kernel.launch(params, temperature), 10)
    plain_2 = cuda_ms(lambda: pure_vle_plain(params, temperature), 2)
    kern, plain = (kern_1 + kern_2) / 2, (plain_1 + plain_2) / 2
    ops, nbytes = vle_work(params, temperature, iters)
    bound_ms, bound_by = bound_of(ops, nbytes)
    print(f"pure_vle: kernels {kern:.4f} ms ({kern_1:.4f}, {kern_2:.4f}), plain {plain:.1f} ms "
          f"({plain_1:.1f}, {plain_2:.1f}), bound {bound_ms:.5f} ms ({bound_by}: {ops:.4e} f64 "
          f"operations), share of bound {bound_ms / kern:.3f}")
    # each stage alone: its evaluations, the row stage once; the scan hands
    # the solve 3 doubles a row
    stages, handover = {}, len(ok) * 3 * 8
    for name, times, evals_a_row, stage_bytes in (
            ("scan", (scan_1, scan_2), torch.full_like(evals, 48),
             len(ok) * BYTES_ROW + len(_ETA_GRID) * 8 + handover),
            ("solve", (solve_1, solve_2), evals - 48, nbytes - len(_ETA_GRID) * 8 + handover)):
        ms = sum(times) / 2
        stage_ops, _ = vle_work(params, temperature, evals_a_row[:, None].expand(-1, 3))
        stage_bound, stage_by = bound_of(stage_ops, stage_bytes)
        stages[name] = {"ms": ms, "bound_ms": stage_bound, "bound_by": stage_by,
                        "share": stage_bound / ms}
        print(f"  pure_vle {name} stage alone: {ms:.4f} ms ({times[0]:.4f}, {times[1]:.4f}), "
              f"bound {stage_bound:.5f} ms ({stage_by}), share of bound {stage_bound / ms:.3f}")
    record = {"ms": kern, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
              "share": bound_ms / kern, "stages": stages, "max_abs_err": abs_err,
              "max_rel_err": rel,
              "kernel_maxima": {"npt": int(npt.max()), "newton": int(newton.max())},
              "plain_loops": {"npt": stats["npt"], "newton": stats["newton"]},
              "mean_evaluations": float(evals.double().mean()), "lanes_busy": lanes}
    return record, (rho_v, rho_l, ok)


def vp_identity_vs_plain(params, temperature, rho_v, rho_l, ok):
    """Phase 3: the vp_identity kernel against autograd of the plain graph
    on the card, at the pure_vle kernel's densities of phase 5's rows
    (sanitised as vapor_pressure does): p~ within VP_RTOL, each partial
    within PARTIALS_BOUND by max_scaled_error; times in turns beside the
    bound."""
    rho_v = torch.where(ok, rho_v, 1e-5)
    rho_l = torch.where(ok, rho_l, 1e-3)
    args = (params, temperature, rho_v, rho_l)
    want = vp_identity_plain(*args)
    got = vp_identity(*args)
    torch.cuda.synchronize()
    rel = float((got[0] / want[0] - 1.0).abs().max())
    errs = [max_scaled_error(got[1][:, j], want[1][:, j]) for j in range(9)]
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    print(f"vp_identity vs plain (B={len(rho_v)}): max rel err p~ {rel:.3e} (rtol "
          f"{VP_RTOL:g}); scaled err of the partials in [m, sigma, eps, mu, kappa_ab, eps_ab, "
          f"na, nb, T] {[float(f'{e:.3e}') for e in errs]} (bound {PARTIALS_BOUND:g}); max abs "
          f"err {abs_err:.3e}")
    check(rel <= VP_RTOL, "vp_identity p~ off the plain graph")
    check(max(errs) < PARTIALS_BOUND, "vp_identity partials off autograd of the plain graph")
    plain_1 = cuda_ms(lambda: vp_identity_plain(*args), 3)
    kern_1 = cuda_ms(lambda: vp_identity(*args), 20)
    kern_2 = cuda_ms(lambda: vp_identity(*args), 20)
    plain_2 = cuda_ms(lambda: vp_identity_plain(*args), 3)
    kern, plain = (kern_1 + kern_2) / 2, (plain_1 + plain_2) / 2
    ops = int(vp_identity_ops(params).sum())
    bound_ms, bound_by = bound_of(ops, len(rho_v) * BYTES_VP_ROW)
    print(f"vp_identity: kernel {kern:.4f} ms ({kern_1:.4f}, {kern_2:.4f}), plain {plain:.3f} "
          f"ms ({plain_1:.3f}, {plain_2:.3f}), bound {bound_ms:.5f} ms ({bound_by}: {ops:.4e} "
          f"f64 operations), share of bound {bound_ms / kern:.3f}")
    return {"ms": kern, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "share": bound_ms / kern, "max_abs_err": abs_err, "max_rel_err_p": rel,
            "max_scaled_err_partials": max(errs)}


def readme_anchors(dev):
    """Phase 4: README vapor pressures and gradient through the port, one
    launch each of pure_vle and vp_identity."""
    p0 = f64(README_PARAMS, dev).requires_grad_()

    def run():
        nans, vp = vapor_pressure(p0.expand(len(README_T), 8), f64(README_T, dev))
        vp[0].backward()
        return nans, vp

    (nans, vp), _, _, by = on_card(run)
    check(not bool(nans.any()), "README rows failed")
    print(f"README rows: launches {by}")
    expect("README vapor pressures", by, pure_vle=1, vp_identity=1)
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


def vapor_pressure_plain(params, temperature):
    """``vapor_pressure`` with its torch-ops twins on any device: the solve
    by ``pure_vle_plain``, the identity's graph through autograd."""
    rho_v, rho_l, ok = pure_vle_plain(params, temperature)
    p_red = identity_plain(params, temperature, torch.where(ok, rho_v, 1e-5),
                           torch.where(ok, rho_l, 1e-3))
    return ~ok, torch.where(ok, p_red * temperature * REDUCED_TO_PA_PER_KT, torch.nan)


def solves_and_grads(params, temperature, plain=False):
    """The main path: vapor pressures, then d/dparams of sum log p over the
    converged rows (bench.py's loss); with ``plain`` its torch-ops twin."""
    p = params.detach().requires_grad_()
    nans, vp = (vapor_pressure_plain if plain else vapor_pressure)(p, temperature)
    log_sum(nans, vp).backward()
    return nans, vp.detach(), p.grad


def main_path(dev, params, temperature, power):
    """Phase 5: the full-size main path, with the launch counts and rate,
    held to its torch-ops twin on the card; where the step's time goes."""
    stats = {}
    pure_vle(params, temperature, stats=stats)  # warm-up; per-row iteration maxima
    torch.cuda.synchronize()
    print(f"solver at B={B}: {stats}")

    (nans, vp, grad), _, launches, by = on_card(lambda: solves_and_grads(params, temperature))
    n_ok = int((~nans).sum())
    print(f"converged {n_ok} of {B} ({100.0 * n_ok / B:.4f}%), launches {by}")
    check(n_ok >= MIN_CONVERGED, f"only {n_ok} of {B} rows converged")
    check(bool(torch.isfinite(grad).all()), "non-finite parameter gradients")
    expect("the main path", by, pure_vle=1, vp_identity=1)
    (p_nans, p_vp, p_grad), plain_sec, _, plain_by = on_card(
        lambda: solves_and_grads(params, temperature, plain=True))
    agree("vapor_pressure", nans, vp, p_nans, p_vp, 1e-10, ref="the plain path on the card")
    err = max_scaled_error(grad, p_grad)
    print(f"  card vs the plain path on the card, d sum log p / d params: max scaled err "
          f"{err:.3e} (bound {PARTIALS_BOUND:g}); the plain path {plain_sec * 1e3:.1f} ms, "
          f"launches {plain_by}")
    check(err < PARTIALS_BOUND, "main path gradients off the plain path's")

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
    record = {"launches": launches, "by_kernel": by, "ms": step * 1e3,
              "converged_per_s": n_ok / step, "plain_ms": plain_sec * 1e3}
    profile(5, "the main path", lambda: solves_and_grads(params, temperature), record)
    return record, nans, vp


KERNELS = ("phi_d2", "pure_vle", "vp_identity")


def counts(rec):
    """Each kernel's launches in a recorder of the port's tracer, phi_d2's
    also by k."""
    c = rec.counters
    by_k = sorted((int(name.rsplit(".k", 1)[1]), n) for name, n in c.items()
                  if name.startswith("launch.phi_d2.k"))
    return {"phi_d2": c.get("launch.phi_d2", 0),
            "phi_d2_by_k": {str(k): n for k, n in by_k},
            "pure_vle": c.get("launch.pure_vle", 0),
            "vp_identity": c.get("launch.vp_identity", 0)}


def on_card(fn):
    """``(fn(), seconds, launches, by kernel)``: ``fn`` runs inside a
    recorder of the port's tracer; ``launches`` is the sum of its kernels'
    launches and ``by kernel`` the :func:`counts`."""
    torch.cuda.synchronize()
    with tracing.record() as rec:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    by = counts(rec)
    return out, seconds, sum(by[k] for k in KERNELS), by


def expect(label, by, **want):
    """Each kernel's launches on a path: an int named for a kernel is its
    exact count, "some" at least one, and a kernel not named launched none."""
    for name in KERNELS:
        w, n = want.get(name, 0), by[name]
        check(n > 0 if w == "some" else n == w,
              f"{label}: {n} {name} launches where {w} were expected")


def launch_counts(seconds, launches, by):
    """A path's entry of the kernels line: its launches by kernel and ms."""
    return {"launches": launches, "by_kernel": by, "ms": seconds * 1e3}


def report(phase, name, nans, seconds, launches, by):
    n_ok = int((~nans).sum())
    print(f"phase {phase} {name}: converged {n_ok} of {nans.numel()}, "
          f"{seconds * 1e3:.1f} ms, launches {launches}: {by}")
    return launch_counts(seconds, launches, by)


def cpu(*xs):
    """The first N_CPU rows of each tensor, as CPU tensors."""
    return [x[:N_CPU].cpu() for x in xs]


def agree(name, nans, card, cpu_nans, cpu_vals, rtol, floor=None, ref="CPU"):
    """The card's results against the plain path's on the CPU (or against
    the ``ref`` named), all CPU tensors of the same rows: equal masks, and
    |card - cpu| <= rtol |cpu| (+ a per-row ``floor``) on the converged
    rows."""
    check(torch.equal(nans, cpu_nans),
          f"{name}: card and {ref} masks differ on {int((nans != cpu_nans).sum())} rows")
    ok = ~nans
    allow = rtol * cpu_vals.abs() + (0.0 if floor is None else floor)
    err = (card - cpu_vals).abs()
    same = err == 0.0  # exact zeros included
    worst = float(torch.where(same, 0.0, err / allow)[ok].max())
    rel = float(torch.where(same, 0.0, err / cpu_vals.abs())[ok].max())
    print(f"  card vs {ref} {name}, {len(nans)} values: masks equal, max rel err {rel:.3e}, "
          f"max err / allowed {worst:.3e} (rtol {rtol:g})")
    check(worst <= 1.0, f"{name}: card and {ref} differ beyond rtol {rtol:g}")


def liquid_densities(params, temperature, p_sat):
    """Phase 6: liquid densities at the vapor pressures of phase 5 and
    saturated liquid densities, each with the gradient of sum log rho."""
    def run(fn, *args):
        p = params.detach().requires_grad_()
        nans, rho = fn(p, *args)
        log_sum(nans, rho).backward()
        return nans, rho.detach(), p.grad

    paths, out = {}, {}
    # liquid_density's NPT solve is phi_d2's; the equilibrium one is pure_vle's
    for name, fn, args, want in (
        ("liquid_density", liquid_density, (temperature, p_sat), {"phi_d2": "some"}),
        ("equilibrium_liquid_density", equilibrium_liquid_density, (temperature,),
         {"pure_vle": 1}),
    ):
        (nans, rho, grad), sec, n, by = on_card(lambda: run(fn, *args))
        paths[name] = report(6, name, nans, sec, n, by)
        expect(name, by, **want)
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

    (nans, t_c, rho_c, grad), sec, n, by = on_card(run)
    path = report(7, "critical_point", nans, sec, n, by)
    path["newton"] = stats["newton"]
    print(f"  critical Newton iterations {stats['newton']} (cap 60)")
    expect("critical_point", by, phi_d2="some")
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

    (nans, t_b, grad), sec, n, by = on_card(run)
    path = report(8, "boiling_temperature", nans, sec, n, by)
    path["outer"] = stats["outer"]
    both = ~nans & ~nans_vp
    rel = float((t_b / temperature - 1.0).abs()[both].max())
    print(f"  secant outer iterations {stats['outer']}; round trip |T_b/T - 1| on "
          f"{int(both.sum())} rows: max {rel:.3e} (bound 1e-9)")
    # a vapor_pressure call a secant step and one to re-attach: one pure_vle
    # and one vp_identity launch each
    expect("boiling_temperature", by, pure_vle="some", vp_identity=by["pure_vle"])
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
    props, sec, n, by = on_card(lambda: pure_properties(params, temperature, rho))
    path = report(9, "pure_properties", nans_l, sec, n, by)
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
    res, sec, n, by = on_card(lambda: run(start, *data))
    rerun = (start, data, res, sec / FIT_STEPS, by)
    losses = res.loss_history.cpu().numpy()
    print(f"phase 10 fit_pure: B={len(start)}, {FIT_STEPS} steps in {sec * 1e3:.1f} ms, "
          f"step {sec / FIT_STEPS * 1e3:.1f} ms, losses {losses.tolist()}, launches "
          f"{n} ({n / FIT_STEPS:g} a step): {by}")
    # a step: one vapor_pressure (pure_vle, vp_identity), one liquid_density
    expect("fit_pure", by, phi_d2="some", pure_vle=FIT_STEPS, vp_identity=FIT_STEPS)
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], "fit_pure loss")
    for name, a, b in (("loss history", card.loss_history, on_cpu.loss_history),
                       ("parameters", card.parameters.flatten(), on_cpu.parameters.flatten())):
        no = torch.zeros(b.shape, dtype=torch.bool)
        agree(f"fit_pure {name}", no, a.cpu(), no, b, 1e-10)
    return {"launches_per_step": n / FIT_STEPS, "ms_per_step": sec / FIT_STEPS * 1e3,
            "by_kernel": by, "steps": FIT_STEPS}, rerun


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
          f"kernel launches {launches}")
    check(launches == 0, "the mixture path launched a kernel")
    for key, got, want in zip(("A", "p~", "mu", "v"), out, cpu_out):
        got, want = got[:N_CPU].cpu().flatten(), want.flatten()
        no = torch.zeros(got.shape, dtype=torch.bool)
        agree(f"mixture derivatives {key}", no, got, no, want, 1e-12)
    return {"launches": launches, "by_kernel": {}, "ms": sec * 1e3}


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
    state, each with the kernel launches it made; ``run(state0=None,
    stats=None)`` returns ``(nans, p, state, gradients)``.  Checks that no
    call launched a kernel, that every row converged with finite gradients,
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
          f"({n_ok / step:.1f} converged solves+gradients/s), loops {stats}, kernel "
          f"launches {launches}; warm start {w_sec * 1e3:.1f} ms, loops {warm_stats}, "
          f"converged {int((~w_nans).sum())}, max |p_warm/p - 1| {warm_rel:.3e} (bound 1e-9)")
    check(launches == 0, f"{label}: the path launched a kernel")
    check(n_ok == rows, f"{label}: only {n_ok} of {rows} rows converged")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    check(bool(w_nans.eq(nans).all()) and warm_rel < 1e-9, f"{label}: warm start")
    return (nans, p, grads), {
        "launches": launches, "by_kernel": {}, "ms": step * 1e3, "first_ms": sec * 1e3,
        "converged": n_ok, "rows": rows, "loops": stats, "warm_ms": w_sec * 1e3,
        "warm_loops": warm_stats}


def agree_gradients(label, names, card, on_cpu, ref="CPU"):
    """Gradients of the card against the CPU's (or ``ref``'s), at 1e-9 with
    a floor of 1e-12 of the largest."""
    for what, g, c in zip(names, card, on_cpu):
        g, c = g.cpu().flatten(), c.flatten()
        no = torch.zeros(g.shape, dtype=torch.bool)
        agree(f"{label} d/d{what}", no, g, no, c, 1e-9, 1e-12 * float(c.abs().max()), ref)


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
    busy, kernels, host_ops, syncs = device_profile(fn)
    record["profile_s"] = time.perf_counter() - t0
    step = record["ms"]
    idle = f"idle share {1.0 - busy / step:.3f}" if kernels else "busy time not measured"
    print(f"phase {phase} profile of {label} ({what}): card busy {busy:.3f} ms in "
          f"{kernels} kernels, {host_ops} aten ops and {syncs} syncs on the host; {idle} of "
          f"the unprofiled median {step:.1f} ms; the profile took {record['profile_s']:.1f} s")
    record.update(busy_ms=busy if kernels else None, kernels=kernels, host_ops=host_ops,
                  syncs=syncs)


def device_profile(fn):
    """``(device ms, kernels, host ops, syncs)`` of one call of ``fn`` under
    ``torch.profiler``: the summed time and count of the kernels the card
    ran, the aten ops the host dispatched, and the host's waits on the card
    (CUDA runtime calls named ``*Synchronize``, the one that closes the
    window among them).  It reads the profiler's raw events:
    ``prof.events()`` builds an event tree first, which took 171 s for the
    5 * 10^5 events of a config 3 bubble-temperature call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_ns, kernels, host_ops, syncs = 0, 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device_ns += e.duration_ns()
            kernels += 1
        elif e.name().startswith("aten::"):
            host_ops += 1
        elif "Synchronize" in e.name():
            syncs += 1
    return device_ns / 1e6, kernels, host_ops, syncs


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
          f"kernel launches {launches}")
    check(launches == 0, "the gc derivative path launched a kernel")
    for key, got, want in zip(("A", "p~", "mu", "v"), out, cpu_out):
        got, want = got[:N_CPU].cpu().flatten(), want.flatten()
        no = torch.zeros(got.shape, dtype=torch.bool)
        agree(f"gc derivatives {key}", no, got, no, want, 1e-12)
    return {"launches": launches, "by_kernel": {}, "ms": sec * 1e3}


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
    with gradients; fit_gc."""
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
          f"losses {losses.tolist()}, k_ab {res.parameters.tolist()}, kernel launches "
          f"{launches}")
    check(launches == 0, "fit_gc launched a kernel")
    check(bool(np.isfinite(losses).all()) and bool(np.all(np.diff(losses) < 0.0)),
          "fit_gc loss does not fall")
    for what, a, b in (("loss history", card.loss_history, on_cpu.loss_history),
                       ("k_ab", card.parameters, on_cpu.parameters)):
        no = torch.zeros(b.shape, dtype=torch.bool)
        agree(f"fit_gc {what}", no, a.cpu(), no, b, 1e-10)
    return {"launches": launches, "by_kernel": {}, "ms_per_step": sec / GC_FIT_STEPS * 1e3,
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


def timed_calls(phase, label, run, rows):
    """Phases 14 and 16: a path's first call with its loop counts (``stats``), then
    the median of MIX_REPS synchronised calls, each with the kernel launches
    it made; ``run(stats=None)`` returns ``(nans, values, gradients)``.
    Checks that no call launched a kernel, that every row converged and that
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
    print(f"phase {phase} {label}: converged {n_ok} of {rows}, first call {sec * 1e3:.1f} ms, "
          f"median {step * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} ms "
          f"({n_ok / step:.1f} converged solves+gradients/s), loops {stats}, kernel "
          f"launches {launches}")
    check(launches == 0, f"{label}: the path launched a kernel")
    check(n_ok == rows, f"{label}: only {n_ok} of {rows} rows converged")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    return (nans, values, grads), {
        "launches": launches, "by_kernel": {}, "ms": step * 1e3, "first_ms": sec * 1e3,
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
            (nans, t, grads), paths[label] = timed_calls(14, label, run, rows)
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
                14, label, partial(gc_temperature_run, model, name, *args), rows)
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

    golden = GcSystem(N_CPU_T, golden=True)
    idx = np.arange(N_CPU_T) % len(GC_ASSOC_ANCHORS["bubble"])
    args = [f64(np.asarray(GC_ASSOC_ANCHORS["bubble"])[idx], "cpu"),
            f64(np.full(N_CPU_T, 0.4), "cpu"), f64(np.full(N_CPU_T, 315.0), "cpu")]
    label = f"gc golden topologies bubble T B={N_CPU_T}"
    stats = {}
    (nans, t, grads), sec, launches, _ = on_card(lambda: gc_temperature_run(
        golden.model(dev), "bubble", *(x.to(dev) for x in args), stats=stats))
    print(f"phase 14 {label}: converged {int((~nans).sum())} of {N_CPU_T}, one call "
          f"{sec * 1e3:.1f} ms, loops {stats}, kernel launches {launches}")
    check(launches == 0 and not bool(nans.any()), f"{label}: launches or failed rows")
    recovers(label, t, 300.0)
    c0 = time.perf_counter()
    c_nans, c_t, c_grads = gc_temperature_run(golden.model("cpu"), "bubble", *args)
    print(f"  {label}: the CPU's call {time.perf_counter() - c0:.1f} s")
    agree(f"{label} T", nans.cpu(), t.cpu(), c_nans, c_t, 1e-10)
    agree_gradients(label, ("segment parameters", "k_ab", "phi"), grads, c_grads)
    paths[label] = {"launches": launches, "by_kernel": {}, "ms": sec * 1e3, "loops": stats}
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
          f"kernel launches {launches}")
    check(launches == 0, "fit_binary launched a kernel")
    check(bool(np.isfinite(losses).all()) and bool(np.all(np.diff(losses) < 0.0)),
          "fit_binary loss does not fall")
    for what, a, b in (("loss history", card.loss_history, on_cpu.loss_history),
                       ("[kij, eps_AiBj]", card.parameters, on_cpu.parameters)):
        no = torch.zeros(b.shape, dtype=torch.bool)
        agree(f"fit_binary {what}", no, a.cpu(), no, b, 1e-8)
    return {"launches": launches, "by_kernel": {}, "ms_per_step": sec / FIT_BINARY_STEPS * 1e3,
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
    300 K and 3e5 Pa, at DIAGRAM_POINTS points, each with its kernel
    launches (the pure seeds) and the closure of its dew curve."""
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
                d, sec, launches, by = on_card(lambda: fn(system, kij, arg, n, device=dev))
            paths[label] = report(14, label, d.nans, sec, launches, by)
            # the pure seeds: vapor pressures (p-x-y), boiling points (T-x-y)
            expect(f"{label} pure seeds", by, pure_vle="some", vp_identity=by["pure_vle"])
            check(not bool(d.nans.any()), f"{label}: failed rows")
            if kind == "p-x-y":
                closes(label, dew, torch.full_like(d.p, arg), d.y1, d.p)
            else:
                closes(label, dew, d.t, d.y1, torch.full_like(d.t, arg))
    model = GcSystem(n).model(dev)
    for kind, fn, arg in (("p-x-y", gc_binary_pxy, 300.0), ("T-x-y", gc_binary_txy, 3e5)):
        label = f"gc config 4 {kind}"
        with torch.no_grad():
            d, sec, launches, by = on_card(lambda: fn(model, arg, n_points=n))
        paths[label] = report(14, label, d.nans, sec, launches, by)
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
def property_case(phase, label, properties, helmholtz, properties_cpu, temperature, z, state):
    """Phases 14(e) and 16(d), one model: the property set at its converged bubble
    states, liquid and vapor; isofugacity across the phases within 1e-8
    plus the liquid p~'s f64 floor; the first N_CPU rows of each phase
    against the CPU at 1e-10 plus the same floors.  ``properties(T, rho)``
    and ``helmholtz(T, rho)`` are the model's on the card,
    ``properties_cpu(T, rho)`` its first N_CPU rows' on the CPU."""
    rows, n = z.shape
    phases = {"liquid": z * torch.exp(state[:, n:]), "vapor": torch.exp(state[:, :n])}
    out, sec, launches, _ = on_card(
        lambda: {name: properties(temperature, rho) for name, rho in phases.items()})
    path = report(phase, f"{label} (liquid and vapor)",
                  torch.zeros(2 * rows, dtype=torch.bool),
                  sec, launches, {})
    check(launches == 0, f"{label}: launched a kernel")
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
        14, "mix_properties config 3", partial(mix_properties, params, kij),
        partial(mix_helmholtz_energy_density, params, kij),
        partial(mix_properties, params[:n].cpu(), kij[:n].cpu()), temperature, z, state)}
    model, temperature, x1, state = gc_states
    g = model.params.detach()
    g_cpu = GcSystem(n).model("cpu", n).params.detach()
    paths["gc_properties"] = property_case(
        14, "gc_properties config 4", partial(gc_properties, g),
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
    the flash's outputs.  Checks that no call launched a kernel and that every
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
          f"({n_two / step:.1f} splits/s), loops {stats}, kernel launches {launches}")
    check(launches == 0, f"{label}: the path launched a kernel")
    check(n_two == rows, f"{label}: {n_two} of {rows} rows split (the oracle splits all)")
    return out, {"launches": launches, "by_kernel": {}, "ms": step * 1e3, "first_ms": sec * 1e3,
                 "two_phase": n_two, "rows": rows, "loops": stats}


@torch.no_grad()
def flash_consistency(label, properties, temperature, z, p, out):
    """tests/test_flash.py's checks on every row, feed ``z (B, n)``: material balance within
    1e-9 and, through the model's residual properties ``properties(T,
    rho)``, the liquid's p within 1e-8 plus its p~ floor, the vapor's within
    1e-8, and isofugacity within 1e-7 plus the floor's share of p."""
    beta, x, y, rho, _ = out
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
    card.  Checks that it launched no kernel, split every row, gave finite
    gradients and the outputs ``out`` of the call without gradients bit for
    bit, and held the phase rule.  Returns its outputs, its gradients and
    the path's record."""
    (out_g, grads, anchors), sec, launches, _ = on_card(run)
    n_two = int((out_g[4] == 2).sum())
    print(f"phase 15 {label}: two-phase {n_two} of {rows}, one call with backward "
          f"{sec * 1e3:.1f} ms ({n_two / sec:.1f} splits+gradients/s), kernel launches "
          f"{launches}")
    check(launches == 0 and n_two == rows, f"{label}: launches or split rows")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    for a, b in zip(out_g, out):
        check(torch.equal(a, b), f"{label}: gradients=True changed an output")
    phase_rule(label, out_g, anchors)
    return out_g, grads, {"launches": launches, "by_kernel": {}, "ms": sec * 1e3,
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
    """Phase 15(a, b): config 6 at FLASH_SIZES without gradients (first
    call, median, consistency, 512 rows on the CPU) and with gradients at
    FLASH_GRAD_ROWS (anchors, 512 rows on the CPU)."""
    paths, times = {}, {}
    for rows in FLASH_SIZES:
        t0 = time.perf_counter()
        params, kij, temperature, x1, p = config6(rows, dev)
        label = f"config 6 flash B={rows}"

        def run(pv, stats=None):
            with torch.no_grad():
                return flash(params, kij, temperature, x1, pv, stats=stats)

        out, paths[label] = flash_rates(label, run, rows, p)
        flash_consistency(label, partial(mix_properties, params, kij), temperature,
                          torch.stack([x1, 1.0 - x1], 1), p, out)
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
    flash_consistency(label, partial(gc_properties, g), temperature,
                      torch.stack([x1, 1.0 - x1], 1), p, out)
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


class Ternary:
    """A ternary cell on ``rows`` rows: ``kind`` "mix" (``params`` the (3, 8)
    components) or "gc" (the gc ternary), feed ``z`` and T =
    linspace(t_lo, t_hi, rows); ``args(dev, n)`` are its first n rows' inputs
    on ``dev``, and ``run`` one bubble or dew call with gradients."""

    def __init__(self, kind, rows, z, t_lo, t_hi, params=None):
        self.kind, self.rows, self.params = kind, rows, params
        self.z, self.t = z, np.linspace(t_lo, t_hi, rows)

    def model(self, dev, n):
        ident, parameter = sauer2014()
        return GcPcSaftMix(ident, parameter, [GC_TERNARY_SEGMENTS] * n,
                           [GC_TERNARY_BONDS] * n, GC_TERNARY_KAB, None, device=dev)

    def args(self, dev, n=None):
        n = self.rows if n is None else n
        head = (self.model(dev, n) if self.kind == "gc"
                else f64(np.tile(self.params, (n, 1, 1)), dev))
        return (head, f64(self.t[:n], dev), f64(np.tile(self.z, (n, 1)), dev),
                f64(np.full(n, 1e5), dev))


def ternary_run(name, head, temperature, z, p0, stats=None):
    """One bubble or dew call of a ternary cell with the gradient of sum ln p
    over the converged rows: in the parameters (``head`` a (B, 3, 8)
    tensor), or in the segment parameters, k_ab and phi (``head`` a
    ``GcPcSaftMix``).  Returns ``(nans, (p, composition, state),
    gradients)``."""
    if isinstance(head, GcPcSaftMix):
        head.zero_grad(set_to_none=True)
        fn = head.bubble_point if name == "bubble" else head.dew_point
        p, nans, comp, state = fn(temperature, z, p0, full_output=True, state_output=True,
                                  stats=stats)
        leaves = [head.parameter, head.kab, head.phi]
    else:
        leaf = head.detach().requires_grad_()
        fn = bubble_point if name == "bubble" else dew_point
        p, nans, comp, state = fn(leaf, None, temperature, z, p0, full_output=True,
                                  state_output=True, stats=stats)
        leaves = [leaf]
    log_sum(nans, p).backward()
    return nans, (p.detach(), comp, state), [x.grad for x in leaves]


def ternary_case(label, name, cell, dev):
    """Phase 16(a-c), one cell: first call and median of MIX_REPS
    (:func:`timed_calls`), and the first N_CPU_TERNARY rows on the card and
    on the CPU (equal masks, p and the incipient composition at 1e-10,
    gradients at 1e-9; the gc gradients are shared by the rows, so both
    devices run those rows alone).  Returns the first call's output and the
    cell's record."""
    run = partial(ternary_run, name, *cell.args(dev))
    (nans, (p, comp, state), grads), record = timed_calls(16, label, run, cell.rows)
    n = N_CPU_TERNARY
    c0 = time.perf_counter()
    c_nans, (c_p, c_comp, _), c_grads = ternary_run(name, *cell.args("cpu", n))
    if cell.kind == "gc":
        _, _, grads = ternary_run(name, *cell.args(dev, n))
    record["cpu_s"] = time.perf_counter() - c0
    print(f"  {label}: {n} rows on the CPU {record['cpu_s']:.1f} s")
    agree(f"{label} p", nans[:n].cpu(), p[:n].cpu(), c_nans, c_p, 1e-10)
    agree(f"{label} composition", nans[:n].cpu().repeat_interleave(3),
          comp[:n].cpu().flatten(), c_nans.repeat_interleave(3), c_comp.flatten(), 1e-10)
    names = ("params",) if cell.kind == "mix" else ("segment parameters", "k_ab", "phi")
    agree_gradients(label, names, (g if cell.kind == "gc" else g[:n] for g in grads), c_grads)
    return (nans, p, comp, state, grads), record


def slot_order(label, name, cell, dev, out):
    """Phase 16(b): every row of the [inert, A, B] solve ``out`` against the
    same rows in the order [A, B, inert] on the card: p and the incipient
    composition within 1e-10 relative, gradients within 1e-9."""
    head, temperature, z, p0 = cell.args(dev)
    nans_j, (p_j, comp_j, _), (g_j,) = ternary_run(
        name, head[:, JAX_ORDER], temperature, z[:, JAX_ORDER], p0)
    nans, p, comp, _, (g,) = out
    back = np.argsort(JAX_ORDER)  # [A, B, inert] -> [inert, A, B]
    ref = "the card's [inert, A, B] solve:"
    agree(f"{label} in the order [A, B, inert] p", nans_j.cpu(), p_j.cpu(), nans.cpu(),
          p.cpu(), 1e-10, ref=ref)
    agree(f"{label} in the order [A, B, inert] composition",
          nans_j.cpu().repeat_interleave(3), comp_j[:, back].cpu().flatten(),
          nans.cpu().repeat_interleave(3), comp.cpu().flatten(), 1e-10, ref=ref)
    agree_gradients(f"{label} in the order [A, B, inert]", ("params",), (g_j[:, back],),
                    (g.cpu(),), ref)


def ternary_temperature(label, cell, dev, target):
    """Phase 16(d): the bubble temperature at the cell's own bubble
    pressures ``target``, from 1.05 T, with the gradient of sum ln T; T
    recovered within 1e-9."""
    head, temperature, z, _ = cell.args(dev)

    def run(stats=None):
        if cell.kind == "gc":
            head.zero_grad(set_to_none=True)
            t, nans = head.bubble_point_t(target, z, 1.05 * temperature, stats=stats)
            leaves = [head.parameter, head.kab, head.phi]
        else:
            leaf = head.detach().requires_grad_()
            t, nans = bubble_point_t(leaf, None, target, z, 1.05 * temperature, stats=stats)
            leaves = [leaf]
        log_sum(nans, t).backward()
        return nans, t.detach(), [x.grad for x in leaves]

    stats = {}
    (nans, t, grads), sec, launches, _ = on_card(lambda: run(stats))
    n_ok = int((~nans).sum())
    print(f"phase 16 {label}: converged {n_ok} of {cell.rows}, one call with backward "
          f"{sec * 1e3:.1f} ms ({n_ok / sec:.1f} solves+gradients/s), loops {stats}, kernel "
          f"launches {launches}")
    check(launches == 0 and n_ok == cell.rows, f"{label}: launches or failed rows")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    recovers(label, t, temperature)
    return {"launches": launches, "by_kernel": {}, "ms": sec * 1e3, "converged": n_ok,
            "rows": cell.rows, "loops": stats}


def ternary_flash(label, cell, dev, p_bub, p_dew):
    """Phase 16(d): the flash at sqrt(p_bub p_dew) without gradients (every
    row splits; material balance and isofugacity as phase 15) and with
    them (outputs bit-identical, finite gradients of sum beta + sum ln
    rho_L)."""
    head, temperature, z, _ = cell.args(dev)
    p = torch.sqrt(p_bub * p_dew)
    if cell.kind == "gc":
        props = partial(gc_properties, head.params.detach())

        def call(gradients=False, stats=None):
            return head.flash(temperature, z, p, gradients=gradients, stats=stats)

        leaves = [head.parameter, head.kab, head.phi]
    else:
        props = partial(mix_properties, head, None)
        leaf = head.detach().requires_grad_()

        def call(gradients=False, stats=None):
            return flash(leaf if gradients else head, None, temperature, z, p,
                         gradients=gradients, stats=stats)

        leaves = [leaf]
    stats = {}
    with torch.no_grad():
        out, sec, launches, _ = on_card(lambda: call(stats=stats))
    n_two = int((out[4] == 2).sum())
    print(f"phase 16 {label}: two-phase {n_two} of {cell.rows}, one call {sec * 1e3:.1f} ms "
          f"({n_two / sec:.1f} splits/s), loops {stats}, kernel launches {launches}")
    check(launches == 0 and n_two == cell.rows, f"{label}: launches or split rows")
    flash_consistency(label, props, temperature, z, p, out)

    def grad_run():
        if cell.kind == "gc":
            head.zero_grad(set_to_none=True)
        beta, x, y, rho, phase = call(gradients=True)
        masked_sum(beta + torch.log(rho[:, 0]), phase != 2).backward()
        return (beta, x, y, rho, phase), [g.grad for g in leaves]

    (out_g, grads), sec_g, launches_g, _ = on_card(grad_run)
    print(f"phase 16 {label} with gradients: one call with backward {sec_g * 1e3:.1f} ms "
          f"({n_two / sec_g:.1f} splits+gradients/s), kernel launches {launches_g}")
    check(launches_g == 0, f"{label}: launched a kernel")
    check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite gradients")
    for a, b in zip(out_g, out):
        check(torch.equal(a.detach(), b), f"{label}: gradients=True changed an output")
    return {"launches": launches + launches_g, "by_kernel": {}, "ms": sec * 1e3,
            "grad_ms": sec_g * 1e3, "two_phase": n_two, "rows": cell.rows, "loops": stats}


def ternary_anchors(dev):
    """Phase 16(e): trace dilution of (a) to its binary within TRACE_RTOL,
    and three associating components raise."""
    temperature = f64(np.linspace(180.0, 200.0, 4), dev)
    p0 = f64(np.full(4, 1e5), dev)
    with torch.no_grad():
        p3, n3 = bubble_point(f64(np.tile(TERNARY, (4, 1, 1)), dev), None, temperature,
                              f64(np.tile(TRACE_Z, (4, 1)), dev), p0)
        p2, n2 = bubble_point(f64(np.tile(TERNARY[:2], (4, 1, 1)), dev), None, temperature,
                              f64(np.full(4, 0.4), dev), p0)
    rel = float((p3 / p2 - 1.0).abs().max())
    print(f"phase 16 trace dilution: ternary with x3 = 1e-8 against the binary at x1 = 0.4, "
          f"max |p3/p2 - 1| {rel:.3e} (bound {TRACE_RTOL:g}; the JAX package's test 1e-5)")
    check(not bool((n3 | n2).any()) and rel <= TRACE_RTOL, "trace dilution")
    three = f64([[CONFIG3[0], CONFIG3[1], CONFIG3[0]]], dev)
    try:
        bubble_point(three, None, f64([150.0], dev), f64([[0.3, 0.3, 0.4]], dev),
                     f64([1e5], dev))
    except ValueError as e:
        print(f"phase 16 three associating components raise: {e}")
    else:
        check(False, "three associating components did not raise")
    return rel


def ternaries(dev):
    """Phase 16: the n-component paths on ternaries (see the constants)."""
    paths, times, cells = {}, {}, {}
    kinds = (("(a) non-associating", "mix", TERNARY, TERNARY_Z, 180.0, 200.0),
             ("(b) cross-associating [inert, A, B]", "mix", CROSS_TERNARY, CROSS_Z, 140.0,
              160.0),
             ("(c) gc butane/propane/pentane", "gc", None, TERNARY_Z, 230.0, 250.0))
    for tag, kind, params, z, t_lo, t_hi in kinds:
        t0 = time.perf_counter()
        for rows in TERNARY_SIZES:
            cell = Ternary(kind, rows, z, t_lo, t_hi, params)
            out = {}
            for name in ("bubble", "dew"):
                label = f"ternary {tag} {name} B={rows}"
                out[name], paths[label] = ternary_case(label, name, cell, dev)
                if tag.startswith("(b)"):
                    slot_order(label, name, cell, dev, out[name])
            below = bool((out["dew"][1] < out["bubble"][1]).all())
            print(f"  ternary {tag} B={rows}: dew below bubble on every row: {below}")
            check(below, f"ternary {tag} B={rows}: dew not below bubble")
            cells[tag[:3], rows] = cell, out
        times[tag[:3]] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for tag in ("(a)", "(c)"):
        cell, out = cells[tag, TERNARY_ROWS]
        label = f"ternary {tag} bubble T B={TERNARY_ROWS}"
        paths[label] = ternary_temperature(label, cell, dev, out["bubble"][1])
        label = f"ternary {tag} flash B={TERNARY_ROWS}"
        paths[label] = ternary_flash(label, cell, dev, out["bubble"][1], out["dew"][1])
    cell, out = cells["(a)", TERNARY_SIZES[-1]]
    head, temperature, z, _ = cell.args(dev)
    n = N_CPU
    paths["mix_properties ternary (a)"] = property_case(
        16, "mix_properties ternary (a)", partial(mix_properties, head, None),
        partial(mix_helmholtz_energy_density, head, None),
        partial(mix_properties, head[:n].cpu(), None), temperature, z, out["bubble"][3])
    times["(d)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    trace = ternary_anchors(dev)
    rows = TERNARY_SIZES[-1]
    label = f"ternary (a) non-associating bubble B={rows}"
    profile(16, label, partial(ternary_run, "bubble", *cells["(a)", rows][0].args(dev)),
            paths[label])
    times["(e)"] = time.perf_counter() - t0
    return paths, times, trace


def data_parallelism(dev, pure_fit, p_data, params_np, temperature_np, nans_vp, p_sat):
    """Phase 17: a one-rank NCCL group (a file store in a temporary
    directory) and its batch mesh on this card, its communicator built by a
    first collective outside the timings; (a) phase 10's fit_pure
    rerun with the mesh (same rows, steps and per-row parameters), its loss
    history and parameters held to phase 10's within 1e-12; (b) DP_STEPS
    steps of phase 14(c)'s fit_binary on FIT_BINARY_ROWS rows with and
    without the mesh, held to each other within 1e-12; (c)
    data_parallel(vapor_pressure) on phase 5's rows padded with NaN rows to
    a multiple of DP_PAD, its rows held to phase 5's within 1e-12 and the
    padded rows masked.  Each with its kernel launches."""
    paths = {}
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        group = initialize_multi_host(num_processes=1, process_id=0, backend="nccl",
                                      init_method=f"file://{tmp}/store")
        check(group == (0, 1), f"one-rank group: {group}")
        try:
            mesh = batch_mesh(device=dev)
            # NCCL builds its communicator at the first collective: not a step's cost
            _, sec, _, _ = on_card(lambda: all_reduce_sum(torch.ones(1, device=dev), mesh))
            print(f"phase 17: NCCL group and first collective {sec * 1e3:.1f} ms")
            start, data, ref, ref_step, ref_by = pure_fit
            res, sec, n, by = on_card(lambda: fit_pure(
                start, data[0], p_sat=data[1], rho_liq=data[2], pressure=data[1],
                steps=FIT_STEPS, mesh=mesh))
            paths["fit_pure mesh"] = launch_counts(sec, n, by)
            print(f"phase 17 fit_pure mesh: B={len(start)}, step {sec / FIT_STEPS * 1e3:.1f} ms "
                  f"against phase 10's {ref_step * 1e3:.1f} ms, launches {n}: {by}")
            # the mesh adds collectives, no solver work: phase 10's launches
            expect("fit_pure with a mesh", by,
                   **{k: ref_by[k] for k in KERNELS})
            for what, a, b in (("loss history", res.loss_history, ref.loss_history),
                               ("parameters", res.parameters.flatten(),
                                ref.parameters.flatten())):
                no = torch.zeros(b.shape, dtype=torch.bool)
                agree(f"fit_pure mesh {what}", no, a.cpu(), no, b.cpu(), 1e-12, ref="phase 10")

            temperature = np.linspace(140.0, 160.0, FIT_BINARY_ROWS)

            def binary(m):
                return fit_binary(CONFIG3, temperature, np.full(FIT_BINARY_ROWS, 0.5),
                                  p_data[:FIT_BINARY_ROWS].cpu().numpy(), kij0=0.0,
                                  epsilon_k_aibj0=900.0, steps=DP_STEPS, device=dev, mesh=m)

            plain, sec_plain, _, _ = on_card(lambda: binary(None))
            res, sec, n, by = on_card(lambda: binary(mesh))
            paths["fit_binary mesh"] = launch_counts(sec, n, by)
            print(f"phase 17 fit_binary: {DP_STEPS} steps on {FIT_BINARY_ROWS} rows, "
                  f"{sec * 1e3:.1f} ms with the mesh, {sec_plain * 1e3:.1f} ms without, "
                  f"losses {res.loss_history.tolist()}, launches {n}")
            for what, a, b in (("loss history", res.loss_history, plain.loss_history),
                               ("[kij, eps_AiBj]", res.parameters, plain.parameters)):
                no = torch.zeros(b.shape, dtype=torch.bool)
                agree(f"fit_binary mesh {what}", no, a.cpu(), no, b.cpu(), 1e-12,
                      ref="no mesh")

            padded = [pad_to_multiple(x, DP_PAD)[0] for x in (params_np, temperature_np)]
            with torch.no_grad():
                (nans, vp), sec, n, by = on_card(
                    lambda: data_parallel(vapor_pressure, mesh, 2)(*padded))
            paths["data_parallel vapor_pressure"] = report(
                17, "data_parallel(vapor_pressure)", nans, sec, n, by)
            check(len(nans) == len(padded[1]) > B and bool(nans[B:].all()),
                  "the padded rows are not masked")
            expect("data_parallel(vapor_pressure)", by, pure_vle=1, vp_identity=1)
            agree("data_parallel(vapor_pressure)", nans[:B].cpu(), vp[:B].cpu(),
                  nans_vp.cpu(), p_sat.cpu(), 1e-12, ref="phase 5")
        finally:
            torch.distributed.destroy_process_group()
    return paths


def load_example(name):
    """``examples_torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples(dev):
    """Phase 18: the six examples of examples_torch/ on the card, the fits
    at EXAMPLE_STEPS steps (each loss must fall), the diagrams at 51 points
    (the dew curve must close), each with its seconds and kernel launches."""
    paths = {}
    for name in EXAMPLES:
        module = load_example(name)
        kwargs = {"steps": EXAMPLE_STEPS[name]} if name in EXAMPLE_STEPS else {}
        out, sec, n, by = on_card(lambda: module.main(device=dev, **kwargs))
        if name.endswith("diagram"):
            n_points = len(out.x1)
            system = f64(np.tile([module.PROPANE, module.BUTANE], (n_points, 1, 1)), dev)
            dew = partial(dew_point, system, None)
            if name == "pxy_diagram":
                closes(name, dew, torch.full_like(out.p, module.T), out.y1, out.p)
            else:
                closes(name, dew, out.t, out.y1, torch.full_like(out.t, module.P))
            expect(f"{name} pure seeds", by, pure_vle="some", vp_identity=by["pure_vle"])
            summary = f"{n_points} points"
        else:
            # a FitResult, or (parameters, loss history) of the examples' own loops
            losses = (out.loss_history.cpu().numpy() if hasattr(out, "loss_history")
                      else out[1])
            check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                  f"{name}: the loss does not fall: {losses.tolist()}")
            summary = f"losses {np.asarray(losses).tolist()}"
        print(f"phase 18 {name}: {sec:.1f} s, {summary}, launches {n}: {by}")
        paths[f"example {name}"] = launch_counts(sec, n, by)
    return paths


def profiled_events(step, steps, tracer_on):
    """The events of the benchmark's two traced windows of ``steps`` steps
    (h100bench/harness.py: the device alone, then host and device), with
    the port's tracer on, as a recording profiler turns it on, or held off:
    ``[(device event names, host events (name, scope, user annotation),
    seconds)]`` of each window."""
    from torch.profiler import ProfilerActivity, profile

    saved = tracing._profiling
    if not tracer_on:
        tracing._profiling = lambda: False
    try:
        out = []
        for activities in ([ProfilerActivity.CUDA],
                           [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    step()
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            dev, host = [], []
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    dev.append(e.name())
                else:
                    host.append((e.name(), e.scope(), e.is_user_annotation()))
            out.append((dev, host, seconds))
        return out
    finally:
        tracing._profiling = saved


def step_ms(step):
    """One step's time in ms, from a CUDA event before it to one after it,
    the stream empty at its start."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def site_costs_us(reps=100_000):
    """The host's cost of one tracer site, in us: a counter off, on (inside
    a record()), and a span entered and left on."""
    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    def one_span():
        with tracing.span("solver.probe"):
            pass

    off = per_call(lambda: tracing.count("sync.probe"))
    with tracing.record():
        on = per_call(lambda: tracing.count("sync.probe"))
        span_on = per_call(one_span)
    return {"count_off": off, "count_on": on, "span_on": span_on}


def tracer_phase(params, temperature, p_sat, rho_l):
    """Phase 19: the port's tracer (feos_tpu_torch/tracing.py) on the card,
    on the steps of the benchmark's cells pure_vp.b100k (vapor pressures and
    the backward of sum ln p) and pure_fit.b100k (fit_pure's loss at 1.01
    times the parameters against phase 5's pressures and phase 6's liquid
    densities, and its backward).  The profiler records FUNCTION-scope
    spans: each window's device events are the same with the tracer on as
    held off, no feos. name is a device event, and the host window's aten
    ops and syncs are the same too; the windows are timed in turns (off,
    on, on, off).  The profiled recorder's counters and the kernel's own phi
    evaluations a row against iters[:, 2] read directly; then each step's
    cost with the tracer on (a record()) and off, in groups of four steps
    (off, on, on, off), and the cost of one site."""
    from collections import Counter

    from feos_tpu_torch.regression import masked_relative_sse

    check(hasattr(torch._C._profiler, "_RecordFunctionFast"),
          f"torch {torch.__version__} has no _RecordFunctionFast")
    q = params.detach().clone().requires_grad_()
    theta = (params * 1.01).detach().requires_grad_()
    p_sat, rho_l = p_sat.detach(), rho_l.detach()
    pressure = torch.where(torch.isfinite(p_sat), p_sat, 1e5).contiguous()

    def vp_step():
        q.grad = None
        nans, vp = vapor_pressure(q, temperature)
        log_sum(nans, vp).backward()

    def fit_step():
        theta.grad = None
        nans_p, vp = vapor_pressure(theta, temperature)
        nans_r, rl = liquid_density(theta, temperature, pressure)
        loss = (masked_relative_sse(torch.where(nans_p, 1.0, vp), p_sat, ~nans_p)
                + masked_relative_sse(torch.where(nans_r, 1.0, rl), rho_l, ~nans_r))
        loss.backward()

    _, _, _, iters = pure_vle_kernel.launch(params, temperature)
    direct = int(iters[:, 2].sum()) / len(iters)
    with tracing.record() as rec:
        vapor_pressure(params, temperature)
    check(rec.phi_evals_per_row() == direct,
          f"tracer phi evaluations {rec.phi_evals_per_row()} against iters[:, 2] {direct}")
    costs = site_costs_us()
    print(f"phase 19 one site: a counter off {costs['count_off']:.3f} us, on "
          f"{costs['count_on']:.3f} us; a span on {costs['span_on']:.3f} us")
    record = {"phi_evals_per_row": direct, "site_us": costs}
    for name, step in (("pure_vp", vp_step), ("pure_fit", fit_step)):
        steps, groups = TRACE_STEPS[name]
        step()
        tracing.profiled = tracing.Recorder()
        held_off, on, on_2, held_off_2 = (profiled_events(step, steps, tracer_on)
                                          for tracer_on in (False, True, True, False))
        rec = tracing.profiled
        runs = (held_off, on, on_2, held_off_2)
        for w, label in enumerate(("device-only", "host-and-device")):
            check(not any(n.startswith(tracing.PREFIX) for run in runs for n in run[w][0]),
                  f"{name} {label} window: a feos. span among the device events")
            check(not any(n.startswith(tracing.PREFIX) for n, _, _ in held_off[w][1]
                          + held_off_2[w][1]),
                  f"{name} {label} window: feos. spans with the tracer held off")
            for kind, pick in (("device events", None), ("aten ops", "aten::"),
                               ("syncs", "Synchronize")):
                tally = [Counter(run[w][0]) if pick is None else
                         Counter(n for n, _, _ in run[w][1]
                                 if (n.startswith(pick) if pick == "aten::" else pick in n))
                         for run in runs]
                for i, t in enumerate(tally[1:], 1):
                    if t != tally[0]:
                        print(f"phase 19 {name} {label} window, {kind}: run {i} (off, on, on, "
                              f"off) against run 0: more {dict(t - tally[0])}, fewer "
                              f"{dict(tally[0] - t)}")
                # a window with the tracer on holds what one held off holds
                check(all(t in (tally[0], tally[3]) for t in tally[1:3]),
                      f"{name} {label} window: the {kind} differ with the tracer on")
        spans = [(n, scope, user) for n, scope, user in on[1][1] if n.startswith(tracing.PREFIX)]
        check(spans and all(scope == 0 and not user for _, scope, user in spans),
              f"{name}: the host window's feos. spans are not all FUNCTION-scope events")
        window_ms = [[1e3 * run[w][2] / steps for run in (held_off, on, on_2, held_off_2)]
                     for w in (0, 1)]
        c = rec.counters
        n_steps = c["calls.entry.vapor_pressure"]
        check(n_steps == 4 * steps, f"{name}: {n_steps} vapor_pressure calls in {4 * steps} steps")
        syncs = {k: n / n_steps for k, n in c.items() if k.startswith("sync.")}
        npt = (c["sync.npt_density"] / c["calls.solver.npt_density"]
               if "calls.solver.npt_density" in c else None)
        sites = sum(n for k, n in c.items() if not k.startswith("rows.")) / n_steps
        evals = rec.phi_evals_per_row()
        if name == "pure_vp":
            check(evals == direct, f"profiled phi evaluations {evals} against {direct}")
        turns = []
        for _ in range(groups):
            off_1 = step_ms(step)
            with tracing.record():
                on_1, on_2 = step_ms(step), step_ms(step)
            turns.append((off_1, on_1, on_2, step_ms(step)))
        off = statistics.median(t for g in turns for t in (g[0], g[3]))
        on_ms = statistics.median(t for g in turns for t in (g[1], g[2]))
        cost_us = statistics.median((g[1] + g[2] - g[0] - g[3]) / 2 for g in turns) * 1e3
        print(f"phase 19 {name}: device events a window {len(on[0][0])} on and held off, "
              f"{len(spans)} feos. spans ({len(set(spans))} names) among "
              f"{len(on[1][1])} host events; windows (off, on, on, off), ms a step: "
              f"device-only {[round(x, 4) for x in window_ms[0]]}, host-and-device "
              f"{[round(x, 4) for x in window_ms[1]]}; syncs in the program a step "
              f"{sum(syncs.values()):g} {syncs}, npt_density syncs a call {npt}, phi "
              f"evaluations a row {evals}, tracer sites a step {sites:g}; step (median of "
              f"{groups} groups off, on, on, off) off {off:.4f}, on {on_ms:.4f} ms, on - off "
              f"(median of the groups) {cost_us:.1f} us")
        record[name] = {"syncs_in_program_per_step": syncs, "npt_syncs_per_call": npt,
                        "phi_evals_per_row": evals, "device_events": len(on[0][0]),
                        "spans": len(spans), "window_ms": window_ms, "sites_per_step": sites,
                        "ms_off": off, "ms_on": on_ms, "on_minus_off_us": cost_us}
    print(json.dumps({"tracer": record}))
    return record


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one card")
    dev = torch.device("cuda", 0)
    power = card()
    print(power)  # the card's name and power limit, as nvidia-smi gives them
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    seconds, mark = {}, [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        seconds[phase] = round(now - mark[0], 1)
        mark[0] = now

    built = build.build()
    print(f"kernel build: {built['seconds']:.1f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  nvcc: {line.strip()}")
    build.library()
    for mangled, (total, f64_all, f64_run) in sass_f64(built["path"]).items():
        print(f"  sass {kernel_name(mangled)}: {total} instructions, {f64_all} f64, "
              f"{f64_run} f64 up to its first exit")
    main_resources = main_kernel_resources(built["log"])
    probes = probe_f64(built["path"].parent)
    print(f"  f64 instructions run: row stage {probes['row']}, at each density "
          f"{probes['base']} (hard sphere, chain, dispersion) + {probes['dipole']} "
          f"(dipole) + {probes['assoc']} (association, na = nb)")
    lap("1-2")

    params_np, temperature_np = make_batch(B, seed=0)
    params, temperature = f64(params_np, dev), f64(temperature_np, dev)
    kernel = kernel_vs_plain(dev, params, temperature)
    vle_kernel, solved = pure_vle_vs_plain(params, temperature)
    vle_kernel["resources"] = {k: main_resources[k] for k in MAIN_KERNELS[:2]}
    vp_kernel = vp_identity_vs_plain(params, temperature, *solved)
    vp_kernel["resources"] = main_resources["vp_identity_kernel"]
    lap("3")
    readme_anchors(dev)
    lap("4")
    main_record, nans_vp, p_sat = main_path(dev, params, temperature, power)
    lap("5")

    # phases 6-10: the rest of the pure-component surface on the same rows
    paths = {"vapor_pressure": main_record}
    nans_l, rho_l, liquid_paths = liquid_densities(params, temperature, p_sat)
    paths.update(liquid_paths)
    lap("6")
    paths["critical_point"] = critical_points(params)
    lap("7")
    paths["boiling_temperature"] = boiling_temperatures(params, temperature, p_sat, nans_vp)
    lap("8")
    paths["pure_properties"] = residual_properties(params, temperature, p_sat, nans_l, rho_l)
    lap("9")
    paths["fit_pure"], pure_fit = fit(params_np, temperature, p_sat, rho_l)
    lap("10")

    # phases 11-12: binary mixtures (torch ops only: no kernel launch)
    paths["mix_derivatives"] = mixture_derivatives(dev)
    lap("11")
    paths.update(mixtures(dev))
    lap("12")

    # phase 13: gc-PC-SAFT (torch ops only: no kernel launch)
    paths["gc_derivatives"] = gc_derivative_set(dev)
    paths.update(gc_mixtures(dev))
    lap("13")

    # phase 14: the binary workload on bubble and dew points (torch ops; the
    # diagrams' pure seeds launch pure_vle and vp_identity)
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
    lap("14")

    # phase 15: the isothermal pT flash (torch ops: no kernel launch)
    t15 = time.perf_counter()
    flash_paths, times = mixture_flash(dev)
    paths.update(flash_paths)
    t15c = time.perf_counter()
    paths.update(gc_flash_phase(dev))
    done = time.perf_counter()
    times["(c)"] = done - t15c
    print(f"phase 15: {done - t15:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(times.items())))
    lap("15")

    # phase 16: n-component mixtures (torch ops: no kernel launch)
    t16 = time.perf_counter()
    ternary_paths, times, _ = ternaries(dev)
    paths.update(ternary_paths)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(times.items())))
    lap("16")

    # phase 17: data parallelism, one rank on this card
    paths.update(data_parallelism(dev, pure_fit, fit_data, params_np, temperature_np, nans_vp,
                                  p_sat))
    lap("17")

    # phase 18: the six examples
    paths.update(examples(dev))
    lap("18")

    # phase 19: the port's tracer
    tracer_phase(params, temperature, p_sat, rho_l)
    lap("19")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s from the start of main; "
          f"seconds by phase {seconds}")

    # phi_d2's path is now liquid_density's NPT solve (k = 1): the main path
    # launches pure_vle and vp_identity, and phi_d2 no more
    shapes = kernel["shapes"]
    ref = shapes["(B, 1)"]
    phi_path = paths["liquid_density"]
    main_by = main_record["by_kernel"]

    def entry(name, source, replaces, launches, record, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": record["max_abs_err"],
                "ms": record["ms"], "plain_ms": record["plain_ms"],
                "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
                # no single PyTorch call computes phi, phi', phi'', a VLE or
                # the identity's partials
                "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        entry("phi_d2", "feos_tpu_torch/csrc/phi_d2.cu", "benchmarks/pallas_experiment.py:158",
              phi_path["by_kernel"]["phi_d2"], {**ref, "max_abs_err": kernel["max_abs_err"]},
              launches_path="liquid_density (phase 6)",
              launches_by_k=phi_path["by_kernel"]["phi_d2_by_k"], shapes=shapes,
              launches_by_path=paths),
        entry("pure_vle", "feos_tpu_torch/csrc/pure_vle.cu", "feos_tpu/solvers/vle.py:409",
              main_by["pure_vle"], vle_kernel, launches_path="vapor_pressure (phase 5)",
              stages=vle_kernel["stages"], resources=vle_kernel["resources"]),
        entry("vp_identity", "feos_tpu_torch/csrc/vp_identity.cu",
              "feos_tpu/models/pcsaft_pure.py:446", main_by["vp_identity"], vp_kernel,
              launches_path="vapor_pressure (phase 5)", resources=vp_kernel["resources"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
