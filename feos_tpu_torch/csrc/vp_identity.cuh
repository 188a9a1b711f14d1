// The vapor-pressure identity and its partials, per row, in f64 forward
// duals: the arithmetic of the vp_identity kernel (vp_identity.cu), built
// for the CPU tests by vp_identity_host.cpp and counted by
// vp_identity_ops.cpp.
//
// At converged coexisting densities (rho_V, rho_L) the reduced pressure is
//
//   p~ = -(a_V - a_L + ln(rho_V / rho_L)) / (1/rho_V - 1/rho_L),
//   a = phi(rho) / rho,
//
// which is stationary in both densities, so its partials in the 8
// parameters and T at fixed densities are the implicit-function derivative
// of the solve (feos_tpu/models/pcsaft_pure.py::vapor_pressure.attach).
// A row seeds one tangent slot for each of [m, sigma, epsilon_k, mu,
// kappa_ab, epsilon_k_ab, na, nb, T], carries them through the generic row
// stage row_consts_of (pcsaft_pure_d3.cuh) and through phi_value below at
// the two densities, and reads p~ and its 9 partials off the result.
//
// phi_value is the value of phi only, written after the plain graph
// (feos_tpu_torch/models/pcsaft_pure.py::phi_pure_pre) term for term.  Its
// association is always the two-site form: the one-root form that phi_d3
// takes for na = nb sees only rho_a = na rho, so its na and nb tangents
// would be wrong.  A term is skipped only where its factor is zero in value
// and in every tangent: the dipole where mu = 0, the association where
// kappa_ab (exp(eps_ab/T) - 1) and both of its tangents vanish (a row with
// kappa_ab > 0 and eps_ab = 0 keeps its eps_ab tangent).
#pragma once

#include "pcsaft_pure_d3.cuh"

namespace feos {
namespace ad {

// the scalar functions of a double, beside the Dual overloads below
using ::exp;
using ::log;
using ::sqrt;

// f64 value and N tangents.  The element type R is double except when
// vp_identity_ops.cpp counts the operations.
template <int N, class R = double>
struct Dual {
    R v;
    R d[N];
    FEOS_HD Dual() : v(0.0) {
        for (int i = 0; i < N; ++i) d[i] = 0.0;
    }
    FEOS_HD Dual(double x) : v(x) {
        for (int i = 0; i < N; ++i) d[i] = 0.0;
    }
    FEOS_HD Dual(R x, int slot) : v(x) {  // the seed of tangent slot `slot`
        for (int i = 0; i < N; ++i) d[i] = i == slot ? 1.0 : 0.0;
    }
};

// f(x) from f0 = f(x.v) and f1 = f'(x.v)
template <int N, class R>
FEOS_HD Dual<N, R> chain(const Dual<N, R>& x, R f0, R f1) {
    Dual<N, R> y;
    y.v = f0;
    for (int i = 0; i < N; ++i) y.d[i] = f1 * x.d[i];
    return y;
}

template <int N, class R>
FEOS_HD Dual<N, R> operator+(const Dual<N, R>& a, const Dual<N, R>& b) {
    Dual<N, R> y;
    y.v = a.v + b.v;
    for (int i = 0; i < N; ++i) y.d[i] = a.d[i] + b.d[i];
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator-(const Dual<N, R>& a, const Dual<N, R>& b) {
    Dual<N, R> y;
    y.v = a.v - b.v;
    for (int i = 0; i < N; ++i) y.d[i] = a.d[i] - b.d[i];
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator-(const Dual<N, R>& a) {
    Dual<N, R> y;
    y.v = -a.v;
    for (int i = 0; i < N; ++i) y.d[i] = -a.d[i];
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator*(const Dual<N, R>& a, const Dual<N, R>& b) {
    Dual<N, R> y;
    y.v = a.v * b.v;
    for (int i = 0; i < N; ++i) y.d[i] = a.d[i] * b.v + a.v * b.d[i];
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator/(const Dual<N, R>& a, const Dual<N, R>& b) {
    const R r = 1.0 / b.v;
    Dual<N, R> y;
    y.v = a.v * r;
    for (int i = 0; i < N; ++i) y.d[i] = (a.d[i] - y.v * b.d[i]) * r;
    return y;
}
// with a constant on one side
template <int N, class R>
FEOS_HD Dual<N, R> operator+(const Dual<N, R>& a, double b) {
    Dual<N, R> y = a;
    y.v = a.v + b;
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator+(double a, const Dual<N, R>& b) { return b + a; }
template <int N, class R>
FEOS_HD Dual<N, R> operator-(const Dual<N, R>& a, double b) {
    Dual<N, R> y = a;
    y.v = a.v - b;
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator-(double a, const Dual<N, R>& b) {
    Dual<N, R> y;
    y.v = a - b.v;
    for (int i = 0; i < N; ++i) y.d[i] = -b.d[i];
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator*(const Dual<N, R>& a, double b) {
    Dual<N, R> y;
    y.v = a.v * b;
    for (int i = 0; i < N; ++i) y.d[i] = a.d[i] * b;
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator*(double a, const Dual<N, R>& b) {
    Dual<N, R> y;
    y.v = a * b.v;
    for (int i = 0; i < N; ++i) y.d[i] = a * b.d[i];
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator/(const Dual<N, R>& a, double b) {
    Dual<N, R> y;
    y.v = a.v / b;
    for (int i = 0; i < N; ++i) y.d[i] = a.d[i] / b;
    return y;
}
template <int N, class R>
FEOS_HD Dual<N, R> operator/(double a, const Dual<N, R>& b) {
    const R r = 1.0 / b.v;
    const R y0 = a * r;
    return chain(b, y0, -y0 * r);
}

template <int N, class R>
FEOS_HD Dual<N, R> exp(const Dual<N, R>& x) {
    const R e = exp(x.v);
    return chain(x, e, e);
}
template <int N, class R>
FEOS_HD Dual<N, R> log(const Dual<N, R>& x) { return chain(x, log(x.v), 1.0 / x.v); }
template <int N, class R>
FEOS_HD Dual<N, R> sqrt(const Dual<N, R>& x) {
    const R s = sqrt(x.v);
    return chain(x, s, 0.5 / s);
}
// torch.clamp(x, max=b): x where x <= b, with its tangents
template <int N, class R>
FEOS_HD Dual<N, R> fmin(const Dual<N, R>& x, const Dual<N, R>& b) { return x.v <= b.v ? x : b; }

template <int N, class R>
FEOS_HD R value_of(const Dual<N, R>& x) { return x.v; }

template <int N, class R>
FEOS_HD bool is_zero(const Dual<N, R>& x) {
    bool zero = x.v == 0.0;
    for (int i = 0; i < N; ++i) zero = zero && x.d[i] == 0.0;
    return zero;
}

}  // namespace ad

FEOS_HD double value_of(double x) { return x; }
FEOS_HD bool is_zero(double x) { return x == 0.0; }

// phi at the density rho (not differentiated in rho) from the row constants
// in the scalar S: the plain graph's terms, in its order.
template <class S>
FEOS_HD S phi_value(const RowConstsT<S>& rc, double rho) {
    const S eta = rc.eta_m * rho;
    const S eta2 = eta * eta;
    const S eta3 = eta2 * eta;
    const S eta_m1 = 1.0 / (1.0 - eta);
    const S eta_m2 = eta_m1 * eta_m1;
    const S etas[7] = {S(1.0), eta, eta2, eta3, eta2 * eta2, eta2 * eta3, eta3 * eta3};

    // hard sphere and hard chain
    const S hs = rc.m * rho * (4.0 * eta - 3.0 * eta2) * eta_m2;
    const S g = (1.0 - eta / 2.0) * eta_m1 * eta_m2;
    const S hc = -rho * (rc.m - 1.0) * log(g);

    // dispersion
    S I1 = rc.c_i1[0] * etas[0], I2 = rc.c_i2[0] * etas[0];
    for (int i = 1; i < 7; ++i) {
        I1 = I1 + rc.c_i1[i] * etas[i];
        I2 = I2 + rc.c_i2[i] * etas[i];
    }
    const S om = 1.0 - eta, tm = 2.0 - eta;
    const S C1 = 1.0 / (1.0 + rc.m * (8.0 * eta - 2.0 * eta2) * eta_m2 * eta_m2 +
                        (1.0 - rc.m) *
                            (20.0 * eta - 27.0 * eta2 + 12.0 * eta2 * eta - 2.0 * eta2 * eta2) /
                            (om * om * tm * tm));
    const S I = 2.0 * I1 + C1 * I2 * rc.me;
    S phi = hs + hc + (-kPi * rho * rho) * rc.m2es3 * I;

    // dipole: the scale-safe Pade phi2 mu2^2 / (1 - r mu2), zero with every
    // tangent where mu = 0
    if (!is_zero(rc.mu2eff)) {
        S J1 = rc.c_j1[0] * etas[0], J2 = rc.c_j2[0] * etas[0];
        for (int i = 1; i < 5; ++i) J1 = J1 + rc.c_j1[i] * etas[i];
        for (int i = 1; i < 4; ++i) J2 = J2 + rc.c_j2[i] * etas[i];
        const S phi2 = -rho * rho * J1 * rc.inv_s3 * kPi;
        const S ratio = rho * (J2 / (value_of(J1) != 0.0 ? J1 : S(1.0))) * (4.0 / 3.0 * kPi);
        phi = phi + phi2 * rc.mu2eff * rc.mu2eff / (1.0 - ratio * rc.mu2eff);
    }

    // association, the two-site closed form
    if (!is_zero(rc.delta_t)) {
        const S k = eta * eta_m1;
        const S delta = (1.0 + k * (1.5 + 0.5 * k)) * eta_m1 * rc.delta_t;
        const S rhoa = rc.na * rho, rhob = rc.nb * rho;
        const S aux = 1.0 + (rhoa - rhob) * delta;
        const S sq = sqrt(aux * aux + 4.0 * rhob * delta);
        const S xa = 2.0 / (sq + 1.0 + (rhob - rhoa) * delta);
        const S xb = 2.0 / (sq + 1.0 - (rhob - rhoa) * delta);
        phi = phi + (rhoa * (log(xa) - 0.5 * xa + 0.5) + rhob * (log(xb) - 0.5 * xb + 0.5));
    }
    return phi;
}

// The identity's value at (rho_v, rho_l) from the row constants in S.
template <class S>
FEOS_HD S vp_identity(const RowConstsT<S>& rc, double rho_v, double rho_l) {
    const S a_l = phi_value(rc, rho_l) / rho_l;
    const S a_v = phi_value(rc, rho_v) / rho_v;
    return -(a_v - a_l + log(rho_v / rho_l)) / (1.0 / rho_v - 1.0 / rho_l);
}

// The 9 tangent slots: the 8 parameters, then T.
constexpr int kSlots = 9;
template <class R = double>
using Dual9 = ad::Dual<kSlots, R>;

// p~ and its partials (9) in the parameters and T of one row at fixed
// (rho_v, rho_l).
template <class R = double>
FEOS_HD void vp_identity_row(const double* par, double temperature, double rho_v,
                             double rho_l, R* ptilde, R* partials) {
    Dual9<R> p[8];
    for (int i = 0; i < 8; ++i) p[i] = Dual9<R>(R(par[i]), i);
    const Dual9<R> t(R(temperature), 8);
    const RowConstsT<Dual9<R>> rc = row_consts_of<Dual9<R>>(p, t);
    const Dual9<R> y = vp_identity(rc, rho_v, rho_l);
    *ptilde = y.v;
    for (int i = 0; i < kSlots; ++i) partials[i] = y.d[i];
}

}  // namespace feos
