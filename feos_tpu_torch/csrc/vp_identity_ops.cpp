// Counts the f64 operations and transcendentals of vp_identity.cuh for one
// row, by building its adjoint on the counting scalar of phi_d2_ops.cpp
// (every +, -, *, / and fmin; every exp, log and sqrt).  An operation with
// an operand of exactly 0 is not counted: those are the adjoints a quantity
// does not receive (md2's on a row with m > 2, where mc = 2), work the
// function does not need.  The bound's operation counts (OPS_VP_* in
// chip_smoke.py) are fixed numbers; tests/test_torch_vp_identity_kernel.py
// holds this tally of the header to them.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libvp_identity_ops.so vp_identity_ops.cpp

#include <math.h>
#include <stdint.h>

namespace count {

struct Tally {
    int64_t ops, exp, log, sqrt;
};
inline Tally tally;

struct Real {
    double v;
    Real() : v(0.0) {}
    Real(double x) : v(x) {}
};

inline void op(Real a, Real b) {
    if (a.v != 0.0 && b.v != 0.0) ++tally.ops;
}

inline Real operator+(Real a, Real b) { op(a, b); return a.v + b.v; }
inline Real operator-(Real a, Real b) { op(a, b); return a.v - b.v; }
inline Real operator*(Real a, Real b) { op(a, b); return a.v * b.v; }
inline Real operator/(Real a, Real b) { op(a, 1.0); return a.v / b.v; }
inline Real operator-(Real a) { return -a.v; }
inline bool operator!=(Real a, Real b) { return a.v != b.v; }
inline bool operator==(Real a, Real b) { return a.v == b.v; }
inline bool operator<=(Real a, Real b) { return a.v <= b.v; }
inline Real fmin(Real a, Real b) { ++tally.ops; return ::fmin(a.v, b.v); }
inline Real exp(Real a) { ++tally.exp; return ::exp(a.v); }
inline Real log(Real a) { ++tally.log; return ::log(a.v); }
inline Real sqrt(Real a) { ++tally.sqrt; return ::sqrt(a.v); }

}  // namespace count

#include "vp_identity.cuh"

// counts = [ops, exp, log, sqrt] of p~ and its 9 partials for the row par
// at T and the densities (rho_v, rho_l).
extern "C" void feos_vp_identity_ops(const double* par, double temperature, double rho_v,
                                     double rho_l, int64_t* counts) {
    count::tally = {};
    count::Real ptilde, partials[feos::kPartials];
    feos::vp_identity_row<count::Real>(par, temperature, rho_v, rho_l, &ptilde, partials);
    const int64_t all[4] = {count::tally.ops, count::tally.exp, count::tally.log,
                            count::tally.sqrt};
    for (int j = 0; j < 4; ++j) counts[j] = all[j];
}
