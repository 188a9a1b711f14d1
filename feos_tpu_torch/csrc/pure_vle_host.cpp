// Host build of the pure_vle kernel's arithmetic, for tests on a machine
// without a GPU: pure_vle_row of pure_vle.cuh, the function each thread of
// the kernel runs, looped over the batch.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libpure_vle_host.so pure_vle_host.cpp

#include <stdint.h>

#include "pure_vle.cuh"

// The outputs of feos_pure_vle (pure_vle.cu), on the host.
extern "C" void feos_pure_vle_host(const double* params, const double* temperature,
                                   const double* eta_grid, double* rho_v, double* rho_l,
                                   uint8_t* ok, int32_t* iters, int64_t B) {
    for (int64_t row = 0; row < B; ++row) {
        const feos::VleRow r = feos::pure_vle_row(params + 8 * row, temperature[row], eta_grid);
        rho_v[row] = r.rho_v;
        rho_l[row] = r.rho_l;
        ok[row] = r.ok;
        iters[3 * row] = r.npt;
        iters[3 * row + 1] = r.newton;
        iters[3 * row + 2] = r.evals;
    }
}
