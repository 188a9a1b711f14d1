// Host build of the pure_vle kernels' arithmetic, for tests on a machine
// without a GPU: the functions of pure_vle.cuh in the kernels' order.  The
// scan gives each of 16 lanes a row's points lane, lane + 16 and lane + 32,
// combines them in that order from the identity, then combines the lanes as
// the kernel's
// __shfl_xor_sync tree does (masks 8, 4, 2, 1); the solve takes lane 0's
// point.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libpure_vle_host.so pure_vle_host.cpp

#include <stdint.h>

#include "pure_vle.cuh"

namespace {

constexpr int kLanes = 16;

feos::ScanPoint scan_row(const feos::RowConsts& rc, const double* eta_grid) {
    feos::ScanPoint lanes[kLanes];
    for (int lane = 0; lane < kLanes; ++lane) {
        lanes[lane] = feos::scan_identity();
        for (int j = lane; j < feos::kGridSize; j += kLanes)
            lanes[lane] = feos::scan_combine(lanes[lane], feos::scan_point(rc, eta_grid, j));
    }
    for (int mask = kLanes / 2; mask > 0; mask >>= 1) {
        feos::ScanPoint next[kLanes];
        for (int lane = 0; lane < kLanes; ++lane)
            next[lane] = feos::scan_combine(lanes[lane], lanes[lane ^ mask]);
        for (int lane = 0; lane < kLanes; ++lane) lanes[lane] = next[lane];
    }
    return lanes[0];
}

}  // namespace

// The outputs of feos_pure_vle (pure_vle.cu), on the host.
extern "C" void feos_pure_vle_host(const double* params, const double* temperature,
                                   const double* eta_grid, double* rho_v, double* rho_l,
                                   uint8_t* ok, int32_t* iters, int64_t B) {
    for (int64_t row = 0; row < B; ++row) {
        const feos::RowConsts rc = feos::row_consts(params + 8 * row, temperature[row]);
        const feos::ScanPoint min = scan_row(rc, eta_grid);
        const feos::Spinodal sp = feos::spinodal_of(min, feos::scan_rho(rc, eta_grid, min.j));
        const feos::SolveConsts c = feos::solve_consts(params + 8 * row, temperature[row], sp);
        const feos::VleRow r =
            feos::solve_row([&]() -> const feos::SolveConsts& { return c; }, sp);
        rho_v[row] = r.rho_v;
        rho_l[row] = r.rho_l;
        ok[row] = r.ok;
        iters[3 * row] = r.npt;
        iters[3 * row + 1] = r.newton;
        iters[3 * row + 2] = r.evals;
    }
}

// scan_combine over n points in a given tree: point i is (dpt[i], pt[i])
// with grid index j[i]; merge k sets slot merges[2k] to scan_combine(slot
// merges[2k], slot merges[2k + 1]), for k < n - 1, and the last merge's
// first slot holds the result.  out = spinodal_of(result) with rho at grid
// index j rho_of[j]: [p_inf, rho_inf, supercritical].
extern "C" void feos_scan_combine_host(const double* dpt, const double* pt, const double* rho_of,
                                       const int32_t* j, const int32_t* merges, int n,
                                       double* out) {
    feos::ScanPoint slots[feos::kGridSize] = {};
    for (int i = 0; i < n; ++i) slots[i] = {dpt[i], pt[i], j[i]};
    int last = 0;
    for (int k = 0; k + 1 < n; ++k) {
        last = merges[2 * k];
        slots[last] = feos::scan_combine(slots[last], slots[merges[2 * k + 1]]);
    }
    const feos::Spinodal s = feos::spinodal_of(slots[last], rho_of[slots[last].j]);
    out[0] = s.p_inf;
    out[1] = s.rho_inf;
    out[2] = s.supercritical ? 1.0 : 0.0;
}
