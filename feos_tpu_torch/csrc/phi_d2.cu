// phi_d2: fused (phi, phi', phi'') of pure PC-SAFT over a (B, k) density
// batch, in f64, for sm_90a.
//
// Replaces the TPU kernel benchmarks/pallas_experiment.py::_kernel, launched
// by pallas_fused (the repo's one pl.pallas_call), whose math is
// phi_elementwise under the nested jvp _fused_d2.  That kernel cut f32
// columns into (32, 128) VMEM blocks; here one thread takes one (row,
// density) element and no blocking is carried over.
//
// What bounds it on the card: an element moves about 104 bytes (8 parameters,
// T, rho in; phi, phi', phi'' out) against several hundred f64 operations
// and 4 transcendentals (2 exp for the row constants, log and sqrt on the
// density side).  That is f64 arithmetic, not memory.  This first design
// does nothing clever about it: each thread recomputes its row's
// density-free constants (2 exp), the dual-number arithmetic stays in
// registers, and the only memory traffic is the 104 bytes.  Sharing the row
// constants across the k densities of a row and tuning register use are
// later work.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing: the wrapper (feos_tpu_torch/kernels/phi_d2.py) owns
// the output.  Built without fast math.

#include <cuda_runtime.h>

#include <stdint.h>

#include "pcsaft_pure_d3.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
phi_d2_kernel(const double* __restrict__ params,
              const double* __restrict__ temperature,
              const double* __restrict__ rho, double* __restrict__ out,
              int64_t B, int64_t k) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i < B * k) feos::phi_d2_at(params, temperature, rho, out, B, k, i);
}

}  // namespace

// params (B, 8), temperature (B,), rho (B, k), out (3, B, k): contiguous f64
// on device `device`.  Returns the cudaError_t of the launch (0 = success).
extern "C" int feos_phi_d2(const void* params, const void* temperature,
                           const void* rho, void* out, int64_t B, int64_t k,
                           int device, void* stream) {
    const int64_t n = B * k;
    if (n == 0) return 0;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    phi_d2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(params), static_cast<const double*>(temperature),
        static_cast<const double*>(rho), static_cast<double*>(out), B, k);
    return static_cast<int>(cudaGetLastError());
}
