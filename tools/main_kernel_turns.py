"""Time versions of the main path's kernels, pure_vle and vp_identity, in turns.

Run from the repository root on a machine with one CUDA card:

    python3 tools/main_kernel_turns.py [LABEL=DIR ...]

Beside this checkout's kernels ("new") it builds variants of them from this
checkout's sources by editing a copy: "fused", pure_vle's scan and solve as
one kernel in two phases (a block scans its 128 rows into shared memory,
then each thread solves a row, both in the order of the rows' regimes);
register caps named for the blocks an SM they allow ("solve3", "solve5",
"scan5", "scan6", "vp5", "vp6"); "solve64", the solve in blocks of 64 rows;
"scan8lanes", the scan with 8 threads a row; "scan16rows", scan blocks of 16
rows; "hoisted", the solve's constants read without hiding their address.
Each DIR holds an earlier version of ``feos_tpu_torch/csrc`` whose
``feos_pure_vle`` takes no scan buffer and no stages (that of the commit
before the scan), e.g. ``mkdir -p build/old && git archive <rev>
feos_tpu_torch/csrc | tar -x --strip-components=2 -C build/old``.

Each version is built with this checkout's nvcc flags into
``build/main_kernel_turns/LABEL/`` (registers, stack frame and spills
printed) and held to the plain versions on ``make_batch(100000, seed=0)``:
pure_vle to equal masks, rho within 1e-10 and this checkout's per-row
counters; vp_identity to p~ within 1e-12 and partials within 1e-10 (scaled),
at this checkout's densities.  The versions are then timed with
``chip_smoke.cuda_ms`` in turns, in the order listed and then in reverse,
and this checkout's two pure_vle stages alone beside them.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from feos_tpu_torch import make_batch  # noqa: E402
from feos_tpu_torch.kernels import build  # noqa: E402
from feos_tpu_torch.kernels import pure_vle as pv  # noqa: E402
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error  # noqa: E402
from feos_tpu_torch.kernels.vp_identity import vp_identity_plain  # noqa: E402
from feos_tpu_torch.solvers.vle import pure_vle_plain  # noqa: E402

OUT = build.BUILD_ROOT.parent / "main_kernel_turns"

FUSED_KERNEL = r"""
// scan and solve as one kernel: a block scans its kThreads rows into shared
// memory, then each thread solves a row; both in the order of the regimes
__global__ void __launch_bounds__(kThreads, kSolveMinBlocks)
pure_vle_fused(const double* __restrict__ params, const double* __restrict__ temperature,
               const double* __restrict__ eta_grid, double* __restrict__ rho_v,
               double* __restrict__ rho_l, uint8_t* __restrict__ ok,
               int32_t* __restrict__ iters, int64_t B) {
    __shared__ double consts[kThreads * kSolveStride];
    __shared__ double grid[feos::kGridSize];
    __shared__ double spin[kThreads * kSpinodal];
    __shared__ int count[kKeys], order[kThreads];
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
    const int rows = B - row0 < kThreads ? static_cast<int>(B - row0) : kThreads;
    auto at = [&](int slot) -> feos::SolveConsts& {
        return *reinterpret_cast<feos::SolveConsts*>(consts + kSolveStride * slot);
    };
    const int r = row_in_regime_order(params, row0, rows, count, order);
    if (r >= 0)
        at(threadIdx.x).rc = feos::row_consts(params + 8 * (row0 + r), temperature[row0 + r]);
    for (int j = threadIdx.x; j < feos::kGridSize; j += kThreads) grid[j] = eta_grid[j];
    __syncthreads();
    const int lane = threadIdx.x % kScanLanes;
    for (int slot = threadIdx.x / kScanLanes; slot < kThreads; slot += kThreads / kScanLanes) {
        const feos::RowConsts& rc = at(slot < rows ? slot : rows - 1).rc;
        feos::ScanPoint p = feos::scan_identity();
#pragma unroll 1
        for (int k = 0; k < kScanPoints; ++k)
            p = feos::scan_combine(p, feos::scan_point(rc, grid, lane + k * kScanLanes));
        for (int mask = kScanLanes / 2; mask > 0; mask >>= 1)
            p = feos::scan_combine(p, shfl_xor(p, mask));
        if (lane == 0 && slot < rows) {
            const feos::Spinodal s = feos::spinodal_of(p, feos::scan_rho(rc, grid, p.j));
            spin[kSpinodal * slot] = s.p_inf;
            spin[kSpinodal * slot + 1] = s.rho_inf;
            spin[kSpinodal * slot + 2] = s.supercritical ? 1.0 : 0.0;
        }
    }
    __syncthreads();
    if (r < 0) return;
    const int64_t row = row0 + r;
    const double* s = spin + kSpinodal * threadIdx.x;
    const feos::Spinodal sp{s[0], s[1], s[2] != 0.0};
    feos::SolveConsts& c = at(threadIdx.x);
    c.lr_max = log(0.74 / c.rc.eta_m);
    c.ln_inf = log(sp.rho_inf);
    const feos::VleRow out = feos::solve_row(Fresh{&c}, sp);
    rho_v[row] = out.rho_v;
    rho_l[row] = out.rho_l;
    ok[row] = out.ok;
    iters[3 * row] = out.npt;
    iters[3 * row + 1] = out.newton;
    iters[3 * row + 2] = out.evals;
}

}  // namespace
"""

FUSED_LAUNCH = """    double* sp = static_cast<double*>(spinodal);
    if (stages == 3) {
        pure_vle_fused<<<static_cast<unsigned>((B + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            p, t, static_cast<const double*>(eta_grid), static_cast<double*>(rho_v),
            static_cast<double*>(rho_l), static_cast<uint8_t*>(ok),
            static_cast<int32_t*>(iters), B);
        return static_cast<int>(cudaGetLastError());
    }
"""


def patched(source, old, new):
    text = (build.CSRC / source).read_text()
    cs.check(old in text, f"{source}: no {old!r} to patch")
    return {source: text.replace(old, new, 1)}


def variants():
    """``{label: {source: text}}`` of the variants built from the checkout
    (the ``.cu`` sources among them are compiled)."""
    solve_cap = "constexpr int kSolveMinBlocks = 4;"
    return {
        "fused": {"pure_vle.cu": patched("pure_vle.cu", "}  // namespace\n", FUSED_KERNEL)[
            "pure_vle.cu"].replace("    double* sp = static_cast<double*>(spinodal);\n",
                                   FUSED_LAUNCH, 1)},
        "solve3": patched("pure_vle.cu", solve_cap, "constexpr int kSolveMinBlocks = 3;"),
        "solve5": patched("pure_vle.cu", solve_cap, "constexpr int kSolveMinBlocks = 5;"),
        "scan5": patched("pure_vle.cu", "constexpr int kScanMinBlocks = 4;",
                         "constexpr int kScanMinBlocks = 5;"),
        "scan6": patched("pure_vle.cu", "constexpr int kScanMinBlocks = 4;",
                         "constexpr int kScanMinBlocks = 6;"),
        # the scan with 8 threads a row (6 points each), 4 rows a warp
        "scan8lanes": patched("pure_vle.cu", "constexpr int kScanLanes = 16; ",
                              "constexpr int kScanLanes = 8;  "),
        # the scan in blocks of 16 rows
        "scan16rows": patched("pure_vle.cu", "constexpr int kScanRows = 32; ",
                              "constexpr int kScanRows = 16; "),
        # the solve's constants read through a plain reference, which lets
        # the compiler hoist their loads into registers
        "hoisted": patched("pure_vle.cu", 'asm volatile("" : "+l"(p));', ""),
        # the solve in blocks of 64 rows, 8 an SM
        "solve64": {"pure_vle.cu": patched("pure_vle.cu", "constexpr int kSolveThreads = 128;",
                                           "constexpr int kSolveThreads = 64;")[
            "pure_vle.cu"].replace("constexpr int kSolveMinBlocks = 4;",
                                   "constexpr int kSolveMinBlocks = 8;")},
        "vp5": patched("vp_identity.cu", "constexpr int kMinBlocks = 4;",
                       "constexpr int kMinBlocks = 5;"),
        "vp6": patched("vp_identity.cu", "constexpr int kMinBlocks = 4;",
                       "constexpr int kMinBlocks = 6;"),
    }


def compile_all(jobs):
    """Build ``{label: (src_dir, [sources])}`` into one library each, every
    nvcc at once; ``{label: (CDLL, resources)}``."""
    procs = []
    for label, (src, names) in jobs.items():
        out = OUT / label
        out.mkdir(parents=True, exist_ok=True)
        for name in names:
            obj = out / f"{Path(name).stem}.o"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{src}", "-c", "-o", str(obj),
                   str(src / name)]
            procs.append((label, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objects = {}, {}
    for label, obj, proc in procs:
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed for {label}:\n{log}")
        logs[label] = logs.get(label, "") + log
        objects.setdefault(label, []).append(str(obj))
    libs = {}
    for label, objs in objects.items():
        lib_path = OUT / label / build.LIB_NAME
        subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-shared", "-o", str(lib_path), *objs],
                       check=True, capture_output=True, text=True, timeout=600)
        libs[label] = (ctypes.CDLL(str(lib_path)), cs.resources(logs[label]))
    return libs


class PureVle:
    """A library's feos_pure_vle on fixed buffers; ``new`` has the scan
    buffer and the stages."""

    def __init__(self, lib, new, params, temperature):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.feos_pure_vle.restype = i32
        lib.feos_pure_vle.argtypes = ([ptr] * 8 + [i64, i32, i32, ptr] if new
                                      else [ptr] * 7 + [i64, i32, ptr])
        self.lib, self.new = lib, new
        self.params, self.temperature = params, temperature
        B, dev = len(temperature), temperature.device
        self.grid = pv._eta_grid(dev)
        self.spinodal = torch.empty((B, 3), dtype=torch.float64, device=dev)
        self.rho_v = torch.empty(B, dtype=torch.float64, device=dev)
        self.rho_l = torch.empty(B, dtype=torch.float64, device=dev)
        self.ok = torch.empty(B, dtype=torch.bool, device=dev)
        self.iters = torch.empty((B, 3), dtype=torch.int32, device=dev)

    def __call__(self, stages=3):
        dev = self.temperature.device
        outs = [self.rho_v.data_ptr(), self.rho_l.data_ptr(), self.ok.data_ptr(),
                self.iters.data_ptr()]
        head = [self.params.data_ptr(), self.temperature.data_ptr(), self.grid.data_ptr()]
        B, stream = len(self.temperature), torch.cuda.current_stream(dev).cuda_stream
        if self.new:
            err = self.lib.feos_pure_vle(*head, self.spinodal.data_ptr(), *outs, B, stages,
                                         dev.index, stream)
        else:
            err = self.lib.feos_pure_vle(*head, *outs, B, dev.index, stream)
        cs.check(err == 0, f"feos_pure_vle: cudaError {err}")


class VpIdentity:
    def __init__(self, lib, params, temperature, rho_v, rho_l):
        ptr = ctypes.c_void_p
        lib.feos_vp_identity.restype = ctypes.c_int
        lib.feos_vp_identity.argtypes = [ptr] * 6 + [ctypes.c_int64, ctypes.c_int, ptr]
        self.lib, self.args = lib, (params, temperature, rho_v, rho_l)
        B, dev = len(temperature), temperature.device
        self.ptilde = torch.empty(B, dtype=torch.float64, device=dev)
        self.partials = torch.empty((B, 9), dtype=torch.float64, device=dev)

    def __call__(self):
        dev = self.ptilde.device
        err = self.lib.feos_vp_identity(
            *(x.data_ptr() for x in self.args), self.ptilde.data_ptr(),
            self.partials.data_ptr(), len(self.ptilde), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        cs.check(err == 0, f"feos_vp_identity: cudaError {err}")


def in_turns(calls, reps):
    """Each call timed in the order given, then in reverse: ``{label: [ms, ms]}``."""
    times = {label: [] for label in calls}
    for label in list(calls) + list(reversed(calls)):
        times[label].append(cs.cuda_ms(calls[label], reps))
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("main_kernel_turns: CUDA is not available")
    print(cs.card())
    dev = torch.device("cuda", 0)
    built = build.build()
    new_lib = build.library()
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = {}
    for label, texts in variants().items():
        src = OUT / label / "src"
        shutil.copytree(build.CSRC, src)
        for name, text in texts.items():
            (src / name).write_text(text)
        jobs[label] = (src, [name for name in texts if name.endswith(".cu")])
    olds = dict(arg.split("=", 1) for arg in sys.argv[1:])
    for label, src in olds.items():
        jobs[label] = (Path(src).resolve(), ["pure_vle.cu", "vp_identity.cu"])
    libs = compile_all(jobs)
    libs["new"] = (new_lib, cs.resources(built["log"]))
    for label, (_, res) in libs.items():
        for kernel, r in res.items():
            if label == "new" or kernel.startswith(("pure_vle", "vp_identity")):
                print(f"{label} {kernel}: {r}")
    for mangled, (total, f64_all, f64_run) in cs.sass_f64(built["path"]).items():
        if "pure_vle" in mangled or "vp_identity" in mangled:
            print(f"new sass {cs.kernel_name(mangled)}: {total} instructions, {f64_all} f64, "
                  f"{f64_run} f64 up to its first exit")
    blocks = (ctypes.c_int * 2)()
    cs.check(new_lib.feos_pure_vle_occupancy(0, blocks) == 0, "occupancy")
    vp_blocks = (ctypes.c_int * 1)()
    cs.check(new_lib.feos_vp_identity_occupancy(0, vp_blocks) == 0, "occupancy")
    print(f"new: resident blocks an SM: scan {blocks[0]}, solve {blocks[1]}, "
          f"vp_identity {vp_blocks[0]} (128 threads a block)")

    params_np, temperature_np = make_batch(cs.B, seed=0)
    params, temperature = cs.f64(params_np, dev), cs.f64(temperature_np, dev)
    want = pure_vle_plain(params, temperature)
    vle_labels = ["new", *olds, "fused", "solve3", "solve5", "solve64", "scan5", "scan6",
                  "scan8lanes", "scan16rows", "hoisted"]
    vle = {label: PureVle(libs[label][0], label not in olds, params, temperature)
           for label in vle_labels}
    for label, run in vle.items():
        run()
        torch.cuda.synchronize()
        rel = max(float((a / b - 1.0).abs()[want[2]].max())
                  for a, b in zip((run.rho_v, run.rho_l), want))
        same_iters = torch.equal(run.iters, vle["new"].iters)
        bitwise = torch.equal(run.rho_v, vle["new"].rho_v) and torch.equal(
            run.rho_l, vle["new"].rho_l)
        print(f"pure_vle {label}: masks equal {torch.equal(run.ok, want[2])}, max rel err rho "
              f"{rel:.3e}, counters equal to new {same_iters}, rho bitwise equal to new {bitwise}")
        cs.check(torch.equal(run.ok, want[2]) and rel <= cs.PURE_VLE_RTOL and same_iters,
                 f"pure_vle {label} off the plain version")
    new = vle["new"]
    calls = {label: vle[label] for label in vle_labels}
    calls["new scan"] = lambda: new(1)
    calls["new solve"] = lambda: new(2)
    for label, ms in in_turns(calls, 10).items():
        print(f"pure_vle {label}: {sum(ms) / len(ms):.4f} ms {[round(t, 4) for t in ms]}")

    rho_v = torch.where(new.ok, new.rho_v, 1e-5)
    rho_l = torch.where(new.ok, new.rho_l, 1e-3)
    ref = vp_identity_plain(params, temperature, rho_v, rho_l)
    vp_labels = ["new", *olds, "vp5", "vp6"]
    vp = {label: VpIdentity(libs[label][0], params, temperature, rho_v, rho_l)
          for label in vp_labels}
    for label, run in vp.items():
        run()
        torch.cuda.synchronize()
        rel = float((run.ptilde / ref[0] - 1.0).abs().max())
        err = max(max_scaled_error(run.partials[:, j], ref[1][:, j]) for j in range(9))
        print(f"vp_identity {label}: max rel err p~ {rel:.3e}, partials {err:.3e}")
        cs.check(rel <= cs.VP_RTOL and err < cs.PARTIALS_BOUND, f"vp_identity {label}")
    for label, ms in in_turns(vp, 20).items():
        print(f"vp_identity {label}: {sum(ms) / len(ms):.4f} ms {[round(t, 4) for t in ms]}")


if __name__ == "__main__":
    main()
