// Host build of the vp_identity kernel's arithmetic, for tests on a machine
// without a GPU: vp_identity_row of vp_identity.cuh, the function each
// thread of the kernel runs, looped over the batch.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libvp_identity_host.so vp_identity_host.cpp

#include <stdint.h>

#include "vp_identity.cuh"

// The outputs of feos_vp_identity (vp_identity.cu), on the host.
extern "C" void feos_vp_identity_host(const double* params, const double* temperature,
                                      const double* rho_v, const double* rho_l,
                                      double* ptilde, double* partials, int64_t B) {
    for (int64_t row = 0; row < B; ++row)
        feos::vp_identity_row(params + 8 * row, temperature[row], rho_v[row], rho_l[row],
                              ptilde + row, partials + feos::kPartials * row);
}
