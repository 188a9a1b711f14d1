// Pure-component PC-SAFT residual Helmholtz energy density phi = A/(kB T V)
// and its first two density derivatives, as a row stage and a density stage.
//
// Written once for both compilers: nvcc builds it into the phi_d2 kernels
// (phi_d2.cu), and a host compiler builds the same arithmetic for the CPU
// tests (phi_d2_host.cpp), where the CUDA qualifiers are defined empty.  The
// math follows feos_tpu/models/pcsaft_pure.py::precompute_pure and
// phi_pure_pre term for term: hard sphere, hard chain, dispersion, PCP-SAFT
// dipole (scale-safe Pade) and the closed-form 2-site association.
//
// * Row stage: row_consts() computes everything that does not depend on
//   density (feos_tpu's PurePre, field for field; 2 exp a row).
// * Density stage: powers() computes the packing-fraction powers and
//   reciprocals the terms share, each Helmholtz term is its own function of
//   (RowConsts, Powers), and phi_d3() adds them.  Every shared reciprocal is
//   taken once: 1/(1-eta), 1/(2-eta), the C1 denominator, the Pade
//   denominator (J1 multiplied through, which removes the J2/J1 division),
//   1/sqrt and the two association roots; the log derivatives reuse them.
//   phi_d3() skips the dipole term of rows with mu = 0 and the association
//   term of rows with kappa_ab (exp(eps_ab/T) - 1) = 0, which are exactly
//   zero there, derivatives included; rows with na = nb take one
//   association root for both sites.
//
// Derivatives ride a second-order Taylor number D3 = (f, f', f''/2) in the
// density, the counterpart of the nested jvp of
// feos_tpu/ops/derivatives.py::value_and_2derivs: keeping f''/2 rather than
// f'' drops the factor 2 from every product and chain rule.  The density
// itself is (rho, 1, 0), and the products with it are written out.
//
// The scalar type is `real`: double, unless FEOS_REAL names another type
// before this header is included (phi_d2_ops.cpp counts the operations so).
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define FEOS_HD __host__ __device__ __forceinline__
#else
#define FEOS_HD inline
#endif

#ifndef FEOS_REAL
#define FEOS_REAL double
#endif

namespace feos {

using real = FEOS_REAL;

constexpr double kPi = 3.14159265358979323846;
constexpr double kMu2Factor = 1e-19 / 1.380649e-23;  // units.MU2_FACTOR

// Taylor coefficients of f(rho + h) = re + v1 h + v2 h^2 + O(h^3):
// v1 = f', v2 = f''/2.
struct D3 {
    real re, v1, v2;
};

FEOS_HD D3 mk(real re) { return {re, 0.0, 0.0}; }
FEOS_HD D3 operator+(D3 a, D3 b) { return {a.re + b.re, a.v1 + b.v1, a.v2 + b.v2}; }
FEOS_HD D3 operator+(D3 a, real b) { return {a.re + b, a.v1, a.v2}; }
FEOS_HD D3 operator+(real a, D3 b) { return {a + b.re, b.v1, b.v2}; }
FEOS_HD D3 operator-(D3 a, D3 b) { return {a.re - b.re, a.v1 - b.v1, a.v2 - b.v2}; }
FEOS_HD D3 operator-(real a, D3 b) { return {a - b.re, -b.v1, -b.v2}; }
FEOS_HD D3 operator*(D3 a, D3 b) {
    return {a.re * b.re, a.v1 * b.re + a.re * b.v1,
            a.v2 * b.re + a.v1 * b.v1 + a.re * b.v2};
}
FEOS_HD D3 operator*(D3 a, real b) { return {a.re * b, a.v1 * b, a.v2 * b}; }
FEOS_HD D3 operator*(real a, D3 b) { return {a * b.re, a * b.v1, a * b.v2}; }
// f(x) from f0 = f(x.re), f1 = f'(x.re), h2 = f''(x.re)/2
FEOS_HD D3 chain(D3 x, real f0, real f1, real h2) {
    return {f0, f1 * x.v1, h2 * x.v1 * x.v1 + f1 * x.v2};
}
// 1/x, given r = 1/x.re
FEOS_HD D3 inv(D3 x, real r) {
    const real r2 = r * r;
    return chain(x, r, -r2, r2 * r);
}
FEOS_HD D3 recip(D3 x) { return inv(x, 1.0 / x.re); }
// log(x), given r = 1/x.re
FEOS_HD D3 dlog(D3 x, real r) { return chain(x, log(x.re), r, -0.5 * r * r); }
FEOS_HD D3 dsqrt(D3 x) {
    const real s = sqrt(x.re);
    const real rs = 1.0 / s;
    return chain(x, s, 0.5 * rs, -0.125 * rs * rs * rs);
}
// rho x and rho^2 for the density rho = (rho, 1, 0)
FEOS_HD D3 times_rho(real rho, D3 x) {
    return {rho * x.re, rho * x.v1 + x.re, rho * x.v2 + x.v1};
}
FEOS_HD D3 rho_squared(real rho) { return {rho * rho, 2.0 * rho, 1.0}; }

// The universal constants (Gross & Sadowski 2001; Gross & Vrabec 2006),
// feos_tpu/constants.py: the dispersion's a_k[i] and b_k[i] (I1's and I2's
// coefficients are a_0 + m1 (a_1 + m2 a_2), m1 = (m - 1)/m, m2 = (m - 2)/m)
// and the dipole's ad, bd, cd.  Returned by a function, not held at
// namespace scope, so that device code may index them.
struct Universal {
    double a[3][7], b[3][7];
    double ad[5][3], bd[3][3], cd[4][3];
};

FEOS_HD Universal universal() {
    return {{{0.91056314451539, 0.63612814494991, 2.68613478913903, -26.5473624914884,
              97.7592087835073, -159.591540865600, 91.2977740839123},
             {-0.30840169182720, 0.18605311591713, -2.50300472586548, 21.4197936296668,
              -65.2558853303492, 83.3186804808856, -33.7469229297323},
             {-0.09061483509767, 0.45278428063920, 0.59627007280101, -1.72418291311787,
              -4.13021125311661, 13.7766318697211, -8.67284703679646}},
            {{0.72409469413165, 2.23827918609380, -4.00258494846342, -21.00357681484648,
              26.8556413626615, 206.5513384066188, -355.60235612207947},
             {-0.57554980753450, 0.69950955214436, 3.89256733895307, -17.21547164777212,
              192.6722644652495, -161.8264616487648, -165.2076934555607},
             {0.09768831158356, -0.25575749816100, -9.15585615297321, 20.64207597439724,
              -38.80443005206285, 93.6267740770146, -29.66690558514725}},
            {{0.30435038064, 0.95346405973, -1.16100802773},
             {-0.13585877707, -1.83963831920, 4.52586067320},
             {1.44933285154, 2.01311801180, 0.97512223853},
             {0.35569769252, -7.37249576667, -12.2810377713},
             {-2.06533084541, 8.23741345333, 5.93975747420}},
            {{0.21879385627, -0.58731641193, 3.48695755800},
             {-1.18964307357, 1.24891317047, -14.9159739347},
             {1.16268885692, -0.50852797392, 15.3720218600}},
            {{-0.06467735252, -0.95208758351, -0.62609792333},
             {0.19758818347, 2.99242575222, 1.29246858189},
             {-0.80875619458, -2.38026356489, 1.65427830900},
             {0.69028490492, -0.27012609786, -3.43967436378}}};
}

// Density-free constants of one parameter row at one temperature: the
// fields of feos_tpu's PurePre, in its order.
struct RowConsts {
    real m;         // segment number
    real eta_m;     // pi/6 m d^3 with d the temperature-dependent diameter
    real c_i1[7];   // I1 eta-polynomial coefficients
    real c_i2[7];   // I2 eta-polynomial coefficients
    real me;        // m eps/T
    real m2es3;     // m^2 (eps/T) sigma^3
    real c_j1[5];   // dipole J1 coefficients ad + bd eps/T
    real c_j2[4];   // dipole J2 coefficients
    real inv_s3;    // 1 / sigma^3
    real mu2eff;    // reduced, T-scaled mu^2: mu^2 MU2_FACTOR / (m T)
    real delta_t;   // (exp(eps_ab/T) - 1) sigma^3 kappa_ab
    real na, nb;
};

// The row stage for par = [m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab,
// na, nb] at temperature T (precompute_pure).
FEOS_HD RowConsts row_consts(const double* par, double temperature) {
    const Universal u = universal();
    const real m = par[0], sigma = par[1], eps_k = par[2], mu = par[3];
    const real kappa_ab = par[4], eps_k_ab = par[5];
    const real inv_t = 1.0 / real(temperature);
    const real e = eps_k * inv_t;
    const real s3 = sigma * sigma * sigma;
    const real inv_m = 1.0 / m;
    const real m1 = (m - 1.0) * inv_m;
    const real m2 = (m - 2.0) * inv_m;
    const real mc = fmin(m, real(2.0));
    const real inv_mc = 1.0 / mc;
    const real md1 = (mc - 1.0) * inv_mc;
    const real md2 = md1 * (mc - 2.0) * inv_mc;
    const real d = sigma * (1.0 - 0.12 * exp(-3.0 * e));

    RowConsts rc;
    rc.m = m;
    rc.eta_m = kPi / 6.0 * m * (d * d * d);
    for (int i = 0; i < 7; ++i) {
        rc.c_i1[i] = m1 * (m2 * u.a[2][i] + u.a[1][i]) + u.a[0][i];
        rc.c_i2[i] = m1 * (m2 * u.b[2][i] + u.b[1][i]) + u.b[0][i];
    }
    rc.me = m * e;
    rc.m2es3 = m * rc.me * s3;
    for (int i = 0; i < 5; ++i) {
        const real a = u.ad[i][0] + md1 * u.ad[i][1] + md2 * u.ad[i][2];
        rc.c_j1[i] =
            i < 3 ? a + (u.bd[i][0] + md1 * u.bd[i][1] + md2 * u.bd[i][2]) * e : a;
    }
    for (int i = 0; i < 4; ++i)
        rc.c_j2[i] = u.cd[i][0] + md1 * u.cd[i][1] + md2 * u.cd[i][2];
    rc.inv_s3 = 1.0 / s3;
    // mu^2 / (m sigma^3 eps) MU2_FACTOR (eps/T) sigma^3, cancelled
    rc.mu2eff = mu * mu * inv_m * inv_t * kMu2Factor;
    rc.delta_t = (exp(eps_k_ab * inv_t) - 1.0) * s3 * kappa_ab;
    rc.na = par[6];
    rc.nb = par[7];
    return rc;
}

// What the terms share at one density rho: eta = eta_m rho, its powers, and
// the reciprocals 1/(1 - eta) (D3) and 1/(2 - eta) (value only).
struct Powers {
    real rho;
    D3 eta, eta2, eta3, eta4, i1, i2;  // i1 = 1/(1 - eta), i2 = i1^2
    real inv2;                         // 1/(2 - eta.re)
};

FEOS_HD Powers powers(const RowConsts& rc, real rho) {
    Powers p;
    p.rho = rho;
    p.eta = {rc.eta_m * rho, rc.eta_m, 0.0};
    p.eta2 = p.eta * p.eta;
    p.eta3 = p.eta2 * p.eta;
    p.eta4 = p.eta2 * p.eta2;
    p.i1 = recip(1.0 - p.eta);
    p.i2 = p.i1 * p.i1;
    p.inv2 = 1.0 / (2.0 - p.eta.re);
    return p;
}

// hard sphere and hard chain
FEOS_HD D3 phi_hs_hc(const RowConsts& rc, const Powers& p) {
    const D3 hs = rc.m * times_rho(p.rho, (4.0 * p.eta - 3.0 * p.eta2) * p.i2);
    // g = (1 - eta/2) / (1 - eta)^3, so 1/g = 2 (1 - eta)^3 / (2 - eta)
    const D3 g = (1.0 - 0.5 * p.eta) * p.i1 * p.i2;
    const real om = 1.0 - p.eta.re;
    const D3 hc = (1.0 - rc.m) * times_rho(p.rho, dlog(g, 2.0 * om * om * om * p.inv2));
    return hs + hc;
}

FEOS_HD D3 phi_disp(const RowConsts& rc, const Powers& p) {
    const D3 etas[7] = {mk(1.0), p.eta, p.eta2, p.eta3, p.eta4,
                        p.eta2 * p.eta3, p.eta3 * p.eta3};
    D3 I1 = mk(rc.c_i1[0]), I2 = mk(rc.c_i2[0]);
    for (int i = 1; i < 7; ++i) {
        I1 = I1 + rc.c_i1[i] * etas[i];
        I2 = I2 + rc.c_i2[i] * etas[i];
    }
    const D3 w = p.i1 * inv(2.0 - p.eta, p.inv2);  // 1/((1 - eta)(2 - eta))
    const D3 C1 = recip(
        1.0 + rc.m * (8.0 * p.eta - 2.0 * p.eta2) * (p.i2 * p.i2) +
        (1.0 - rc.m) *
            (20.0 * p.eta - 27.0 * p.eta2 + 12.0 * p.eta3 - 2.0 * p.eta4) * (w * w));
    const D3 I = 2.0 * I1 + rc.me * C1 * I2;
    return (-kPi * rc.m2es3) * rho_squared(p.rho) * I;
}

// Dipole: the scale-safe Pade phi2 mu2^2 / (1 - r mu2) with
// r = rho (J2/J1) 4pi/3, here with J1 multiplied through numerator and
// denominator.  A J1 of exactly 0 is replaced there by the constant 1,
// whose derivatives are 0, as the torch.where of the plain version does.
FEOS_HD D3 phi_dipole(const RowConsts& rc, const Powers& p) {
    const D3 etas[5] = {mk(1.0), p.eta, p.eta2, p.eta3, p.eta4};
    D3 J1 = mk(rc.c_j1[0]), J2 = mk(rc.c_j2[0]);
    for (int i = 1; i < 5; ++i) J1 = J1 + rc.c_j1[i] * etas[i];
    for (int i = 1; i < 4; ++i) J2 = J2 + rc.c_j2[i] * etas[i];
    const D3 phi2 = (-kPi * rc.inv_s3) * rho_squared(p.rho) * J1;
    const D3 j1 = J1.re != 0.0 ? J1 : mk(1.0);
    const D3 den = j1 - (4.0 / 3.0 * kPi * rc.mu2eff) * times_rho(p.rho, J2);
    return (rc.mu2eff * rc.mu2eff) * phi2 * j1 * recip(den);
}

FEOS_HD bool has_dipole(const RowConsts& rc) { return rc.mu2eff != 0.0; }
FEOS_HD bool has_assoc(const RowConsts& rc) { return rc.delta_t != 0.0; }
FEOS_HD bool symmetric_sites(const RowConsts& rc) { return rc.na == rc.nb; }

// Association, the closed-form 2-site solution X_A = 2/da, X_B = 2/db, at
// rho_a = na rho, rho_b = nb rho and association strength delta.
FEOS_HD D3 assoc_sites(D3 rhoa, D3 rhob, D3 delta) {
    const D3 aux = 1.0 + (rhoa - rhob) * delta;
    const D3 sq = dsqrt(aux * aux + 4.0 * rhob * delta);
    const D3 w = (rhob - rhoa) * delta;
    const D3 da = sq + 1.0 + w;
    const D3 db = sq + 1.0 - w;
    const D3 xa = 2.0 * inv(da, 1.0 / da.re);
    const D3 xb = 2.0 * inv(db, 1.0 / db.re);
    // d log(x)/dx = 1/x = da/2 or db/2: no division
    return rhoa * (dlog(xa, 0.5 * da.re) - 0.5 * xa + 0.5) +
           rhob * (dlog(xb, 0.5 * db.re) - 0.5 * xb + 0.5);
}

// The same with as many A as B sites: X_A = X_B, one root serves both.
FEOS_HD D3 assoc_symmetric(D3 rhoa, D3 delta) {
    const D3 da = dsqrt(1.0 + 4.0 * rhoa * delta) + 1.0;
    const D3 xa = 2.0 * inv(da, 1.0 / da.re);
    return 2.0 * rhoa * (dlog(xa, 0.5 * da.re) - 0.5 * xa + 0.5);
}

FEOS_HD D3 assoc_delta(const RowConsts& rc, const Powers& p) {
    const D3 k = p.eta * p.i1;
    return (1.0 + k * (1.5 + 0.5 * k)) * p.i1 * rc.delta_t;
}

FEOS_HD D3 phi_assoc(const RowConsts& rc, const Powers& p) {
    const D3 delta = assoc_delta(rc, p);
    const D3 rhoa = {rc.na * p.rho, rc.na, 0.0};
    if (symmetric_sites(rc)) return assoc_symmetric(rhoa, delta);
    return assoc_sites(rhoa, {rc.nb * p.rho, rc.nb, 0.0}, delta);
}

// phi at one density: the sum of the terms, skipping the exact zeros
FEOS_HD D3 phi_d3(const RowConsts& rc, real rho) {
    const Powers p = powers(rc, rho);
    D3 phi = phi_hs_hc(rc, p) + phi_disp(rc, p);
    if (has_dipole(rc)) phi = phi + phi_dipole(rc, p);
    if (has_assoc(rc)) phi = phi + phi_assoc(rc, p);
    return phi;
}

}  // namespace feos
