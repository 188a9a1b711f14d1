// vp_identity: the vapor-pressure identity p~ and its partials in the 8
// parameters and T, one thread a row, by a hand-written adjoint in f64, for
// sm_90a.
//
// The main path's backward (feos_tpu_torch/kernels/vp_identity.py::
// VaporPressureIdentity).  The JAX package differentiates the identity with
// one hand-written rule (feos_tpu/models/pcsaft_pure.py::_identity_grads,
// used by vapor_pressure.attach); the torch-ops twin builds its autograd
// graph, some 650 elementwise kernels forward and backward.  Here a thread
// runs the row stage, one pass at each density that computes phi and adds
// its weighted partials to the adjoints of the row quantities, and the row
// stage's adjoint (vp_identity.cuh), and writes p~ and the 9 partials; the
// backward is then one product of the cotangent with them.
//
// What bounds it.  A row reads 11 doubles (8 parameters, T, rho_V, rho_L)
// and writes 10 (p~, 9 partials): 168 bytes.  The operations, tallied on a
// counting scalar without those on exact zeros (vp_identity_ops.cpp), are
// 626-1,187 a row, which at the f64 peak take less time than the bytes at
// the memory rate (chip_smoke.py prints both).
//
// What the design does about it.  Reverse mode: the partials cost about 3
// value passes, where forward mode carries 9 tangents through every
// operation (about 10, and 32 row constants of 10 doubles, which spill).
// The weights of phi_V and phi_L in p~ do not depend on phi, so each
// density's pass takes its adjoint term by term right after the term's
// value, and only 14 row quantities, their adjoints and two exponentials
// live across the passes.  Capped at 128 registers: 16 warps an SM, no spill (at 96 or 80
// it spills and runs slower; PERF.md has the times).
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing: the wrapper owns the outputs.  Built without fast math.

#include <cuda_runtime.h>

#include <stdint.h>

#include "vp_identity.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // caps the kernel at 128 registers

__global__ void __launch_bounds__(kThreads, kMinBlocks)
vp_identity_kernel(const double* __restrict__ params, const double* __restrict__ temperature,
                   const double* __restrict__ rho_v, const double* __restrict__ rho_l,
                   double* __restrict__ ptilde, double* __restrict__ partials, int64_t B) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (row >= B) return;
    feos::vp_identity_row(params + 8 * row, temperature[row], rho_v[row], rho_l[row],
                          ptilde + row, partials + feos::kPartials * row);
}

}  // namespace

// params (B, 8), temperature, rho_v, rho_l (B,): contiguous f64 on device
// `device`; out ptilde (B,) and partials (B, 9) f64.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int feos_vp_identity(const void* params, const void* temperature, const void* rho_v,
                                const void* rho_l, void* ptilde, void* partials, int64_t B,
                                int device, void* stream) {
    if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const int64_t blocks = (B + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    vp_identity_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(params), static_cast<const double*>(temperature),
        static_cast<const double*>(rho_v), static_cast<const double*>(rho_l),
        static_cast<double*>(ptilde), static_cast<double*>(partials), B);
    return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM of the kernel at its launch's block size, in *out.
extern "C" int feos_vp_identity_occupancy(int device, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, vp_identity_kernel, kThreads, 0);
    return static_cast<int>(err);
}
