// pure_vle: the whole pure-component VLE solve of a row batch in f64, for
// sm_90a, as two kernels on the caller's stream: a spinodal scan with 16
// threads a row, then the solve with one thread a row.
//
// The main path's solve (feos_tpu_torch/solvers/vle.py::pure_vle on a CUDA
// tensor).  The JAX package runs it as per-row lax.while_loops under vmap
// (feos_tpu/solvers/vle.py::pure_vle), which XLA compiles into fused loop
// bodies; the torch-ops twin, pure_vle_plain, runs it as batched loops of
// elementwise kernels around phi_d2 launches with a host sync an iteration.
// Here the batch is one call of feos_pure_vle and no sync.
//
// What bounds it.  A row moves 72 bytes in (8 parameters and T) and 29 out
// (two densities, the mask, three int32 counters), but does 48 + about 23
// phi evaluations of 321-580 f64 operations each (phi_d2_ops.cpp's counts),
// so the f64 peak bounds it.  What the time follows instead: the f64 and
// other instructions a warp issues per evaluation, every branch of phi_d3
// that one of its rows takes, and in the solve its slowest row.
//
// What the design does about it.  Both kernels take a block's rows in the
// order of their regimes (dipole, association), so that a warp's rows
// mostly take the same branches of phi_d3.
//
// * pure_vle_scan: the 48 grid points of a row are independent, so 16
//   threads take a row, 3 points each (one at a time: one inlined phi_d3),
//   and reduce to the row's minimum by __shfl_xor_sync with scan_combine
//   (pure_vle.cuh), which gives the serial scan's point in any order; a
//   warp covers 2 rows.  A block first puts its 32 rows' constants into
//   shared memory at an odd stride, so that the two rows of a warp hit
//   different banks.  Capped at 128 registers (16 warps an SM): at 96 or 80
//   it spills and runs slower.
// * pure_vle_solve: one thread a row runs the rest (about 23 evaluations).
//   Its row constants and two logs of the row sit in shared memory and are
//   read at each evaluation (the compiler would otherwise hoist them into
//   registers and spill); the solve is one loop with one phi_d3, so the
//   kernel holds one copy of it and rows of a warp in different stages meet
//   there; the NPT lanes are named scalars, with no stack frame.  Capped at
//   128 registers: 16 warps an SM, no spill.  Its evaluations cost about
//   twice the scan's: the NPT and Newton steps, the stage changes a warp's
//   rows take at different iterations, and a warp that waits for its
//   slowest row; 12 warps an SM run it as fast as 16.
// * Two kernels, not one in two phases: one kernel is allocated registers
//   for its larger phase, and measured slower.  They hand over 3 doubles a
//   row (p_inf, rho_inf, supercritical) in a buffer the wrapper owns, 2.4 MB
//   at 100,000 rows, which stays in L2.
//
// PERF.md has the times of these designs and of the ones measured and
// dropped (tools/main_kernel_turns.py builds them).
//
// The launches go on the caller's stream, do not synchronise and allocate
// nothing: the wrapper (feos_tpu_torch/kernels/pure_vle.py) owns the
// outputs and the buffer.  Built without fast math.

#include <cuda_runtime.h>

#include <stdint.h>

#include "pure_vle.cuh"

namespace {

constexpr int kThreads = 128;              // a scan block's threads
constexpr int kSolveThreads = 128;         // a solve block's threads (rows)
constexpr int kScanLanes = 16;             // threads a row in the scan
constexpr int kScanPoints = feos::kGridSize / kScanLanes;  // points a thread
constexpr int kScanRows = 32;              // rows a scan block
constexpr int kScanMinBlocks = 4;          // caps the scan at 128 registers
constexpr int kSolveMinBlocks = 4;         // caps the solve at 128 registers
// RowConsts (scan) and SolveConsts (solve) in shared memory at an odd
// stride of doubles, so that neighbouring rows hit different banks
constexpr int kStride = sizeof(feos::RowConsts) / sizeof(double) + 1;
constexpr int kSolveStride = sizeof(feos::SolveConsts) / sizeof(double) + 1;
constexpr int kSpinodal = 3;               // doubles a row handed to the solve
constexpr int kKeys = 4;  // the regimes of phi_d3's optional terms

static_assert(feos::kGridSize % kScanLanes == 0, "a row's points split evenly");
static_assert(32 % kScanLanes == 0, "a row's threads lie in one warp");

__device__ __forceinline__ feos::RowConsts& row_at(double* smem, int r) {
    return *reinterpret_cast<feos::RowConsts*>(smem + kStride * r);
}

// Which of phi_d3's optional terms the row par takes, 0-3: the dipole
// where mu != 0, the association where kappa_ab and eps_ab are not 0.  Only
// an order of work: a row whose term vanishes otherwise (an underflow) is
// computed all the same.
__device__ __forceinline__ int regime(const double* par) {
    return 2 * (par[3] != 0.0) + (par[4] != 0.0 && par[5] != 0.0);
}

// The first n rows of the block (row0 + i) in the order of their regimes:
// returns the row thread threadIdx.x takes, so that the rows of one regime
// sit in neighbouring threads and a warp's threads run the same branches of
// phi_d3.  What a row computes does not depend on the thread that takes it.
// Called by the whole block (it synchronises); -1 past the n rows.
__device__ int row_in_regime_order(const double* params, int64_t row0, int n, int* count,
                                   int* order) {
    const bool has = static_cast<int>(threadIdx.x) < n;
    const int key = has ? regime(params + 8 * (row0 + threadIdx.x)) : 0;
    if (threadIdx.x < kKeys) count[threadIdx.x] = 0;
    __syncthreads();
    const int pos = has ? atomicAdd(&count[key], 1) : 0;
    __syncthreads();
    if (has) {
        int base = 0;
        for (int k = 0; k < key; ++k) base += count[k];
        order[base + pos] = threadIdx.x;
    }
    __syncthreads();
    return has ? order[threadIdx.x] : -1;
}

__device__ __forceinline__ feos::ScanPoint shfl_xor(const feos::ScanPoint& p, int mask) {
    constexpr unsigned kAll = 0xffffffffu;
    feos::ScanPoint q;
    q.dpt = __shfl_xor_sync(kAll, p.dpt, mask);
    q.pt = __shfl_xor_sync(kAll, p.pt, mask);
    q.j = __shfl_xor_sync(kAll, p.j, mask);
    return q;
}

// kScanRows rows a block, in the order of their regimes; out (B, 3) =
// [p_inf, rho_inf, supercritical].
__global__ void __launch_bounds__(kThreads, kScanMinBlocks)
pure_vle_scan(const double* __restrict__ params, const double* __restrict__ temperature,
              const double* __restrict__ eta_grid, double* __restrict__ out, int64_t B) {
    __shared__ double rcs[kScanRows * kStride];
    __shared__ double grid[feos::kGridSize];
    __shared__ int count[kKeys], order[kThreads], rows_of[kScanRows];
    static_assert(kScanRows <= kThreads, "a thread a row for the row stage");
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kScanRows;
    const int rows = B - row0 < kScanRows ? static_cast<int>(B - row0) : kScanRows;
    // slot i holds the constants of row rows_of[i]
    const int r = row_in_regime_order(params, row0, rows, count, order);
    if (r >= 0) {
        row_at(rcs, threadIdx.x) =
            feos::row_consts(params + 8 * (row0 + r), temperature[row0 + r]);
        rows_of[threadIdx.x] = r;
    }
    for (int j = threadIdx.x; j < feos::kGridSize; j += kThreads) grid[j] = eta_grid[j];
    __syncthreads();
    const int lane = threadIdx.x % kScanLanes;
    // the two groups of a warp take neighbouring slots; every thread of a
    // warp takes part in the shuffles: past the last row a group scans the
    // last row again and writes nothing
    for (int slot = threadIdx.x / kScanLanes; slot < kScanRows;
         slot += kThreads / kScanLanes) {
        const feos::RowConsts& rc = row_at(rcs, slot < rows ? slot : rows - 1);
        // one point at a time, one inlined phi_d3
        feos::ScanPoint p = feos::scan_identity();
#pragma unroll 1
        for (int k = 0; k < kScanPoints; ++k)
            p = feos::scan_combine(p, feos::scan_point(rc, grid, lane + k * kScanLanes));
#pragma unroll
        for (int mask = kScanLanes / 2; mask > 0; mask >>= 1)
            p = feos::scan_combine(p, shfl_xor(p, mask));
        if (lane == 0 && slot < rows) {
            const feos::Spinodal s = feos::spinodal_of(p, feos::scan_rho(rc, grid, p.j));
            double* o = out + kSpinodal * (row0 + rows_of[slot]);
            o[0] = s.p_inf;
            o[1] = s.rho_inf;
            o[2] = s.supercritical ? 1.0 : 0.0;
        }
    }
}

// The solve's constants at the address c, read anew at each call: the
// empty asm hides that the address does not change, so the compiler cannot
// hoist the loads out of the solve's loop into registers (where, under the
// register cap, they spill).
struct Fresh {
    const feos::SolveConsts* c;
    __device__ __forceinline__ const feos::SolveConsts& operator()() const {
        const feos::SolveConsts* p = c;
        asm volatile("" : "+l"(p));
        return *p;
    }
};

// A thread a row of the block, the rows in the order of their regimes;
// their constants in shared memory.
__global__ void __launch_bounds__(kSolveThreads, kSolveMinBlocks)
pure_vle_solve(const double* __restrict__ params, const double* __restrict__ temperature,
               const double* __restrict__ spinodal, double* __restrict__ rho_v,
               double* __restrict__ rho_l, uint8_t* __restrict__ ok,
               int32_t* __restrict__ iters, int64_t B) {
    __shared__ double consts[kSolveThreads * kSolveStride];
    __shared__ int count[kKeys], order[kSolveThreads];
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kSolveThreads;
    const int rows = B - row0 < kSolveThreads ? static_cast<int>(B - row0) : kSolveThreads;
    const int r = row_in_regime_order(params, row0, rows, count, order);
    if (r < 0) return;
    const int64_t row = row0 + r;
    const double* s = spinodal + kSpinodal * row;
    const feos::Spinodal sp{s[0], s[1], s[2] != 0.0};
    // a thread reads only the constants it wrote: no barrier
    feos::SolveConsts& c =
        *reinterpret_cast<feos::SolveConsts*>(consts + kSolveStride * threadIdx.x);
    c = feos::solve_consts(params + 8 * row, temperature[row], sp);
    const feos::VleRow out = feos::solve_row(Fresh{&c}, sp);
    rho_v[row] = out.rho_v;
    rho_l[row] = out.rho_l;
    ok[row] = out.ok;
    iters[3 * row] = out.npt;
    iters[3 * row + 1] = out.newton;
    iters[3 * row + 2] = out.evals;
}

}  // namespace

// params (B, 8), temperature (B,), eta_grid (48,), spinodal (B, 3) scratch:
// contiguous f64 on device `device`; out rho_v, rho_l (B,) f64, ok (B,)
// bytes, iters (B, 3) int32 = [NPT iterations, Newton iterations, phi
// evaluations].  Launches the scan (stages & 1), then the solve (stages &
// 2): the wrapper asks for both, a measurement for one at a time.  Returns
// the cudaError_t of the launches (0 = success).
extern "C" int feos_pure_vle(const void* params, const void* temperature, const void* eta_grid,
                             void* spinodal, void* rho_v, void* rho_l, void* ok, void* iters,
                             int64_t B, int stages, int device, void* stream) {
    if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const int64_t scan_blocks = (B + kScanRows - 1) / kScanRows;
    const int64_t solve_blocks = (B + kSolveThreads - 1) / kSolveThreads;
    if (scan_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const double* p = static_cast<const double*>(params);
    const double* t = static_cast<const double*>(temperature);
    double* sp = static_cast<double*>(spinodal);
    if (stages & 1) {
        pure_vle_scan<<<static_cast<unsigned>(scan_blocks), kThreads, 0, s>>>(
            p, t, static_cast<const double*>(eta_grid), sp, B);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (stages & 2) {
        pure_vle_solve<<<static_cast<unsigned>(solve_blocks), kSolveThreads, 0, s>>>(
            p, t, sp, static_cast<double*>(rho_v), static_cast<double*>(rho_l),
            static_cast<uint8_t*>(ok), static_cast<int32_t*>(iters), B);
        err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

// Resident blocks an SM of each kernel at its launch's block size and
// shared memory: out[0] the scan's, out[1] the solve's.
extern "C" int feos_pure_vle_occupancy(int device, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, pure_vle_scan, kThreads, 0);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, pure_vle_solve, kSolveThreads,
                                                            0);
    return static_cast<int>(err);
}
