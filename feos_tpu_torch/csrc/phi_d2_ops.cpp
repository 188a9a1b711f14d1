// Counts the f64 operations and transcendentals of pcsaft_pure_d3.cuh by
// building it on a scalar type that tallies every +, -, *, / and fmin, and
// every exp, log and sqrt.  A sign change is not counted.  In the density
// stage an operation with an operand of exactly 0 is not counted either:
// those are the known zeros of the Taylor numbers (the f''/2 of eta and of
// rho_a, the derivatives of a constant), work the function does not need.
// The bound's operation counts (OPS_* in chip_smoke.py) are fixed numbers;
// tests/test_torch_phi_d2.py holds this tally of the header to them.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libphi_d2_ops.so phi_d2_ops.cpp

#include <math.h>
#include <stdint.h>

namespace count {

struct Tally {
    int64_t ops, exp, log, sqrt;
};
inline Tally tally;
inline bool skip_zeros = false;

struct Real {
    double v;
    Real() : v(0.0) {}
    Real(double x) : v(x) {}
};

inline void op(Real a, Real b) {
    if (!(skip_zeros && (a.v == 0.0 || b.v == 0.0))) ++tally.ops;
}

inline Real operator+(Real a, Real b) { op(a, b); return a.v + b.v; }
inline Real operator-(Real a, Real b) { op(a, b); return a.v - b.v; }
inline Real operator*(Real a, Real b) { op(a, b); return a.v * b.v; }
inline Real operator/(Real a, Real b) { op(a, 1.0); return a.v / b.v; }
inline Real operator-(Real a) { return -a.v; }
inline bool operator!=(Real a, Real b) { return a.v != b.v; }
inline bool operator==(Real a, Real b) { return a.v == b.v; }
inline Real fmin(Real a, Real b) { ++tally.ops; return ::fmin(a.v, b.v); }
inline Real exp(Real a) { ++tally.exp; return ::exp(a.v); }
inline Real log(Real a) { ++tally.log; return ::log(a.v); }
inline Real sqrt(Real a) { ++tally.sqrt; return ::sqrt(a.v); }

}  // namespace count

#define FEOS_REAL count::Real
#include "pcsaft_pure_d3.cuh"

// counts[0:4]: ops, exp, log, sqrt of the row stage for row par at T;
// counts[4:8]: the same of phi_d3 at one density rho of that row.
extern "C" void feos_phi_d2_ops(const double* par, double temperature, double rho,
                                int64_t* counts) {
    count::tally = {};
    count::skip_zeros = false;
    const feos::RowConsts rc = feos::row_consts(par, temperature);
    const count::Tally row = count::tally;
    count::tally = {};
    count::skip_zeros = true;
    feos::phi_d3(rc, rho);
    const count::Tally elem = count::tally;
    const int64_t all[8] = {row.ops, row.exp, row.log, row.sqrt,
                            elem.ops, elem.exp, elem.log, elem.sqrt};
    for (int j = 0; j < 8; ++j) counts[j] = all[j];
}
