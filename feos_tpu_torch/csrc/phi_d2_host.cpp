// Host build of the phi_d2 kernel's arithmetic, for tests on a machine
// without a GPU: the same per-element function, looped over the batch.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libphi_d2_host.so phi_d2_host.cpp

#include <stdint.h>

#include "pcsaft_pure_d3.cuh"

extern "C" void feos_phi_d2_host(const double* params, const double* temperature,
                                 const double* rho, double* out, int64_t B,
                                 int64_t k) {
    for (int64_t i = 0; i < B * k; ++i)
        feos::phi_d2_at(params, temperature, rho, out, B, k, i);
}
