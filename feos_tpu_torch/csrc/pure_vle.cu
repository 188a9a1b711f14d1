// pure_vle: the whole pure-component VLE solve of a row batch, one thread
// a row, in f64, for sm_90a.
//
// The main path's solve (feos_tpu_torch/solvers/vle.py::pure_vle on a CUDA
// tensor).  The JAX package runs it as per-row lax.while_loops under vmap
// (feos_tpu/solvers/vle.py::pure_vle), which XLA compiles into fused loop
// bodies; the torch-ops twin, pure_vle_plain, runs it as batched loops of
// elementwise kernels around phi_d2 launches with a host sync an iteration.
// Here a thread runs its row's whole solve (pure_vle.cuh) and exits on its
// own: the batch is one launch and no sync.
//
// What bounds it.  A row moves 72 bytes in (8 parameters and T) and 24 out
// (two densities, the mask, three int32 counters), but does 48 + about 40
// phi evaluations of 321-580 f64 operations each (phi_d2_ops.cpp's counts),
// so the f64 peak bounds it.  What the time follows instead: a warp runs
// its slowest row, and rows take 1-60 NPT and 1-80 Newton iterations.
//
// What the design does about it.  The row constants are computed once and
// kept in registers; each loop has one call site of phi_d3 for all of its
// lanes (the lanes are a loop that is not unrolled), so the kernel holds
// four inlined copies of phi_d3 rather than seven; a lane that is done is
// not evaluated, and a NaN row's NPT lanes are done from the start.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing: the wrapper (feos_tpu_torch/kernels/pure_vle.py) owns
// the outputs.  Built without fast math.

#include <cuda_runtime.h>

#include <stdint.h>

#include "pure_vle.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pure_vle_kernel(const double* __restrict__ params, const double* __restrict__ temperature,
                const double* __restrict__ eta_grid, double* __restrict__ rho_v,
                double* __restrict__ rho_l, uint8_t* __restrict__ ok,
                int32_t* __restrict__ iters, int64_t B) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const feos::VleRow r = feos::pure_vle_row(params + 8 * row, temperature[row], eta_grid);
    rho_v[row] = r.rho_v;
    rho_l[row] = r.rho_l;
    ok[row] = r.ok;
    iters[3 * row] = r.npt;
    iters[3 * row + 1] = r.newton;
    iters[3 * row + 2] = r.evals;
}

}  // namespace

// params (B, 8), temperature (B,), eta_grid (48,): contiguous f64 on device
// `device`; out rho_v, rho_l (B,) f64, ok (B,) bytes, iters (B, 3) int32 =
// [NPT iterations, Newton iterations, phi evaluations].  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int feos_pure_vle(const void* params, const void* temperature, const void* eta_grid,
                             void* rho_v, void* rho_l, void* ok, void* iters, int64_t B,
                             int device, void* stream) {
    if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    pure_vle_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(params), static_cast<const double*>(temperature),
        static_cast<const double*>(eta_grid), static_cast<double*>(rho_v),
        static_cast<double*>(rho_l), static_cast<uint8_t*>(ok), static_cast<int32_t*>(iters), B);
    return static_cast<int>(cudaGetLastError());
}
