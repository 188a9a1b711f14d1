// Host build of the phi_d2 kernels' arithmetic, for tests on a machine
// without a GPU: the row stage and the density stage of pcsaft_pure_d3.cuh,
// the same functions the kernels call, looped over the batch.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libphi_d2_host.so phi_d2_host.cpp

#include <stdint.h>
#include <string.h>

#include "pcsaft_pure_d3.cuh"

namespace {

static_assert(sizeof(feos::RowConsts) == 32 * sizeof(double), "RowConsts is 32 doubles");

// out (3, n) = [phi, phi', phi''] at element i
void put(double* out, int64_t n, int64_t i, feos::D3 phi) {
    out[i] = phi.re;
    out[n + i] = phi.v1;
    out[2 * n + i] = 2.0 * phi.v2;
}

}  // namespace

// The row stage: rc (B, 32) in RowConsts field order.
extern "C" void feos_row_consts_host(const double* params, const double* temperature,
                                     double* rc, int64_t B) {
    for (int64_t row = 0; row < B; ++row) {
        const feos::RowConsts c = feos::row_consts(params + 8 * row, temperature[row]);
        memcpy(rc + 32 * row, &c, sizeof c);
    }
}

static feos::RowConsts load(const double* rc, int64_t row) {
    feos::RowConsts c;
    memcpy(&c, rc + 32 * row, sizeof c);
    return c;
}

// The density stage from given row constants: out (3, B, k).
extern "C" void feos_phi_d3_host(const double* rc, const double* rho, double* out,
                                 int64_t B, int64_t k) {
    for (int64_t row = 0; row < B; ++row) {
        const feos::RowConsts c = load(rc, row);
        for (int64_t i = row * k; i < (row + 1) * k; ++i)
            put(out, B * k, i, feos::phi_d3(c, rho[i]));
    }
}

// Each term alone, none skipped: out (4, 3, B, k) for hard sphere + hard
// chain, dispersion, dipole, association.
extern "C" void feos_phi_terms_host(const double* rc, const double* rho, double* out,
                                    int64_t B, int64_t k) {
    const int64_t n = B * k;
    for (int64_t row = 0; row < B; ++row) {
        const feos::RowConsts c = load(rc, row);
        for (int64_t i = row * k; i < (row + 1) * k; ++i) {
            const feos::Powers p = feos::powers(c, rho[i]);
            put(out, n, i, feos::phi_hs_hc(c, p));
            put(out + 3 * n, n, i, feos::phi_disp(c, p));
            put(out + 6 * n, n, i, feos::phi_dipole(c, p));
            put(out + 9 * n, n, i, feos::phi_assoc(c, p));
        }
    }
}

// Both stages, as the kernels run them: out (3, B, k).
extern "C" void feos_phi_d2_host(const double* params, const double* temperature,
                                 const double* rho, double* out, int64_t B,
                                 int64_t k) {
    for (int64_t row = 0; row < B; ++row) {
        const feos::RowConsts c = feos::row_consts(params + 8 * row, temperature[row]);
        for (int64_t i = row * k; i < (row + 1) * k; ++i)
            put(out, B * k, i, feos::phi_d3(c, rho[i]));
    }
}
