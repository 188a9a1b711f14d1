// vp_identity: the vapor-pressure identity p~ and its partials in the 8
// parameters and T, one thread a row, in f64 forward duals, for sm_90a.
//
// The main path's backward (feos_tpu_torch/kernels/vp_identity.py::
// VaporPressureIdentity).  The JAX package differentiates the identity with
// one hand-written rule (feos_tpu/models/pcsaft_pure.py::_identity_grads,
// used by vapor_pressure.attach); the torch-ops twin builds its autograd
// graph, some 650 elementwise kernels forward and backward.  Here a thread
// carries 9 tangent slots through the row stage and phi at both densities
// (vp_identity.cuh) and writes p~ and the partials; the backward is then
// one product of the cotangent with them.
//
// What bounds it.  A row reads 11 doubles (8 parameters, T, rho_V, rho_L)
// and writes 10 (p~, 9 partials): 168 bytes.  The operations, tallied on a
// counting scalar without those on exact zeros (vp_identity_ops.cpp), are a
// few thousand a row, which at the f64 peak take longer than the bytes at
// the memory rate (chip_smoke.py prints both).
//
// What the design does about it: nothing yet.  A RowConsts of 32 duals of
// 10 doubles does not fit in registers, so the row constants live in local
// memory (nvcc's --resource-usage reports the spill); a simple kernel that
// is right comes first.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing: the wrapper owns the outputs.  Built without fast math.

#include <cuda_runtime.h>

#include <stdint.h>

#include "vp_identity.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
vp_identity_kernel(const double* __restrict__ params, const double* __restrict__ temperature,
                   const double* __restrict__ rho_v, const double* __restrict__ rho_l,
                   double* __restrict__ ptilde, double* __restrict__ partials, int64_t B) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (row >= B) return;
    feos::vp_identity_row(params + 8 * row, temperature[row], rho_v[row], rho_l[row],
                          ptilde + row, partials + feos::kSlots * row);
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
