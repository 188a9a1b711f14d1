// phi_d2: fused (phi, phi', phi'') of pure PC-SAFT over a (B, k) density
// batch, in f64, for sm_90a.
//
// Replaces the TPU kernel benchmarks/pallas_experiment.py::_kernel, launched
// by pallas_fused (the repo's one pl.pallas_call, :158), whose math is
// phi_elementwise under the nested jvp _fused_d2.  That kernel cut f32
// columns into (32, 128) VMEM blocks; nothing of that blocking carries over.
//
// What bounds it.  An element moves 32 bytes (rho in; phi, phi', phi''
// out) and a row 72 more (8 parameters and T).  The arithmetic of
// pcsaft_pure_d3.cuh, counted on a tallying scalar (phi_d2_ops.cpp) without
// the operations on known zeros, is 146 f64 operations and 2 exp a row, and
// at each density 321 operations and a log, plus 94 for a dipolar row and
// 93 (na = nb) or 165 for an associating one.  On make_batch(100000) rows,
// against the H100's 34 TFLOP/s of f64 and 3.35 TB/s (chip_smoke.py prints
// these):
//   (B, 48), the spinodal scan, 1 launch a solve:  54 us, f64 operations;
//   (B, 2), NPT lanes and 2x2 Newton, 16 launches:  4.1 us, bytes;
//   (B, 1), the vapour NPT lane, 5 launches:         3.1 us, bytes.
// (The first version's arithmetic, 936 operations an element with the row
// stage in every element, bounds them at 112, 5.1 and 3.1 us.)  The bound
// counts an operation as one of the 34 TFLOP/s, two a lane a cycle, which
// only a stream of fused multiply-adds reaches; the f64 SASS instructions
// an element runs, and a launch of about 2.3 us, are what the time follows.
//
// What the design does about it.  The header splits the math into a row
// stage (RowConsts) and a density stage, takes each shared reciprocal once,
// carries f''/2 so that products need no factor 2, and skips the dipole and
// association terms where they are exactly zero.  feos_phi_d2 picks the
// variant from k:
//
// * tile (k >= 3): a block takes a tile of rows, computes each row's
//   RowConsts once into shared memory (at an odd stride, so that threads
//   reading neighbouring rows hit different banks), and its threads sweep
//   the tile's densities, 6 each, coalesced along k.  The row stage is paid
//   once per 48 densities, and a warp covers one or two rows, so the terms a
//   row skips are skipped by whole warps.  Capped at 80 registers (6 blocks
//   an SM) without spills.
// * row (k = 2): one thread per row computes RowConsts in registers and
//   sweeps the row's densities: half the row stages of elem.
// * elem (k = 1): one thread per element, capped at 128 registers (4
//   blocks an SM).
//
// Measured and dropped (PERF.md has the times): elem without the register
// cap, no faster at k = 1 and slower elsewhere; and term-parallel lanes,
// where 4 lanes share an element, each takes one Helmholtz term and
// __shfl_xor_sync adds them.  A warp runs the four terms' code one after
// another with a quarter of its lanes on, so lanes spent about 4
// instruction slots for the work of one and lost 2.7-6x.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing: the wrapper (feos_tpu_torch/kernels/phi_d2.py) owns
// the output.  Built without fast math.

#include <cuda_runtime.h>

#include <stdint.h>

#include "pcsaft_pure_d3.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTilePerThread = 6;  // elements a thread takes in the tile variant
constexpr int kTileMinBlocks = 6;  // caps the tile kernel at 80 registers
constexpr int kElemMinBlocks = 4;  // caps the elem kernel at 128 registers
// RowConsts in shared memory at an odd stride of doubles, so that threads
// reading the constants of neighbouring rows hit different banks
constexpr int kTileStride = sizeof(feos::RowConsts) / sizeof(double) + 1;

// out (3, n) = [phi, phi', phi''] at element i
__device__ __forceinline__ void put(double* out, int64_t n, int64_t i, feos::D3 phi) {
    out[i] = phi.re;
    out[n + i] = phi.v1;
    out[2 * n + i] = 2.0 * phi.v2;
}

__device__ __forceinline__ feos::RowConsts& tile_row(double* smem, int r) {
    return *reinterpret_cast<feos::RowConsts*>(smem + kTileStride * r);
}

// The row of element i: a shift for the solver's k of 1 and 2.
__device__ __forceinline__ int64_t row_of(int64_t i, int64_t k) {
    return k == 1 ? i : (k == 2 ? i >> 1 : i / k);
}

// rows_per_block rows a block: their RowConsts into shared memory, then
// the block's rows * k elements.
__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
phi_d2_tile(const double* __restrict__ params, const double* __restrict__ temperature,
            const double* __restrict__ rho, double* __restrict__ out, int64_t B,
            int64_t k, int rows_per_block) {
    extern __shared__ double smem[];
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
    const int rows = B - row0 < rows_per_block ? static_cast<int>(B - row0) : rows_per_block;
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
        tile_row(smem, r) = feos::row_consts(params + 8 * (row0 + r), temperature[row0 + r]);
    __syncthreads();
    const int64_t n = B * k;
    const int64_t base = row0 * k;
    const int count = rows * static_cast<int>(k);
    for (int e = threadIdx.x; e < count; e += blockDim.x)
        put(out, n, base + e,
            feos::phi_d3(tile_row(smem, static_cast<int>(row_of(e, k))), rho[base + e]));
}

// One thread per element.
__global__ void __launch_bounds__(kThreads, kElemMinBlocks)
phi_d2_elem(const double* __restrict__ params, const double* __restrict__ temperature,
            const double* __restrict__ rho, double* __restrict__ out, int64_t B,
            int64_t k) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t n = B * k;
    if (i >= n) return;
    const int64_t row = row_of(i, k);
    const feos::RowConsts rc = feos::row_consts(params + 8 * row, temperature[row]);
    put(out, n, i, feos::phi_d3(rc, rho[i]));
}

// One thread per row, sweeping the row's k densities.
__global__ void __launch_bounds__(kThreads)
phi_d2_row(const double* __restrict__ params, const double* __restrict__ temperature,
           const double* __restrict__ rho, double* __restrict__ out, int64_t B,
           int64_t k) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const feos::RowConsts rc = feos::row_consts(params + 8 * row, temperature[row]);
    for (int64_t i = row * k; i < (row + 1) * k; ++i)
        put(out, B * k, i, feos::phi_d3(rc, rho[i]));
}

// A launch of the same grid that does no work, to time the launch itself.
__global__ void phi_d2_empty() {}

enum Variant { kTile, kRow, kElem };

// The variant for k densities a row.
Variant pick(int64_t k) { return k >= 3 ? kTile : (k == 2 ? kRow : kElem); }

struct Launch {
    int64_t blocks;
    size_t smem;
    int rows_per_block;  // tile only
};

Launch configure(Variant variant, int64_t B, int64_t k) {
    switch (variant) {
        case kTile: {
            // kTilePerThread elements a thread, at most kThreads rows (32 KB)
            const int64_t per_block = static_cast<int64_t>(kThreads) * kTilePerThread;
            const int rows = static_cast<int>(
                k >= per_block ? 1 : (per_block / k < kThreads ? per_block / k : kThreads));
            return {(B + rows - 1) / rows, rows * kTileStride * sizeof(double), rows};
        }
        case kRow: return {(B + kThreads - 1) / kThreads, 0, 0};
        default: return {(B * k + kThreads - 1) / kThreads, 0, 0};
    }
}

// Launches the variant for k, or with `empty` a kernel that does nothing on
// the same grid; the pointers are unused then.
int launch(const void* params, const void* temperature, const void* rho, void* out,
           int64_t B, int64_t k, bool empty, int device, void* stream) {
    if (k <= 0 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const Variant variant = pick(k);
    const Launch l = configure(variant, B, k);
    if (l.blocks > 2147483647LL || k > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(l.blocks)), block(kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const double* p = static_cast<const double*>(params);
    const double* t = static_cast<const double*>(temperature);
    const double* r = static_cast<const double*>(rho);
    double* o = static_cast<double*>(out);
    if (empty) {
        phi_d2_empty<<<grid, block, l.smem, s>>>();
    } else {
        switch (variant) {
            case kTile: phi_d2_tile<<<grid, block, l.smem, s>>>(p, t, r, o, B, k, l.rows_per_block); break;
            case kRow: phi_d2_row<<<grid, block, 0, s>>>(p, t, r, o, B, k); break;
            default: phi_d2_elem<<<grid, block, 0, s>>>(p, t, r, o, B, k); break;
        }
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// params (B, 8), temperature (B,), rho (B, k), out (3, B, k): contiguous f64
// on device `device`.  Launches the variant for k and returns the
// cudaError_t of the launch (0 = success).
extern "C" int feos_phi_d2(const void* params, const void* temperature, const void* rho,
                           void* out, int64_t B, int64_t k, int device, void* stream) {
    return launch(params, temperature, rho, out, B, k, false, device, stream);
}

// A kernel that does nothing, on the grid feos_phi_d2 launches for (B, k):
// the launch's own time, for measurement.
extern "C" int feos_phi_d2_empty(int64_t B, int64_t k, int device, void* stream) {
    return launch(nullptr, nullptr, nullptr, nullptr, B, k, true, device, stream);
}
