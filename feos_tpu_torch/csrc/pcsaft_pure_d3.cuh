// Pure-component PC-SAFT residual Helmholtz energy density phi = A/(kB T V)
// and its first two density derivatives, for one (row, density) element.
//
// Written once for both compilers: nvcc builds it into the phi_d2 kernel
// (phi_d2.cu), and a host compiler builds the same arithmetic for the CPU
// tests, where the CUDA qualifiers are defined empty.  The math follows
// feos_tpu/models/pcsaft_pure.py::precompute_pure and phi_pure_pre term for
// term: hard sphere, hard chain, dispersion, PCP-SAFT dipole (scale-safe
// Pade) and the closed-form 2-site association.
//
// Derivatives ride a second-order dual number (value, d/drho, d2/drho2)
// seeded with drho = 1, the counterpart of the nested jvp of
// feos_tpu/ops/derivatives.py::value_and_2derivs.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define FEOS_HD __host__ __device__ __forceinline__
#else
#define FEOS_HD inline
#endif

namespace feos {

constexpr double kPi = 3.14159265358979323846;
constexpr double kMu2Factor = 1e-19 / 1.380649e-23;  // units.MU2_FACTOR

struct D3 {
    double re, v1, v2;
};

FEOS_HD D3 mk(double re) { return {re, 0.0, 0.0}; }
FEOS_HD D3 operator+(D3 a, D3 b) { return {a.re + b.re, a.v1 + b.v1, a.v2 + b.v2}; }
FEOS_HD D3 operator+(D3 a, double b) { return {a.re + b, a.v1, a.v2}; }
FEOS_HD D3 operator+(double a, D3 b) { return {a + b.re, b.v1, b.v2}; }
FEOS_HD D3 operator-(D3 a) { return {-a.re, -a.v1, -a.v2}; }
FEOS_HD D3 operator-(D3 a, D3 b) { return {a.re - b.re, a.v1 - b.v1, a.v2 - b.v2}; }
FEOS_HD D3 operator-(double a, D3 b) { return {a - b.re, -b.v1, -b.v2}; }
FEOS_HD D3 operator-(D3 a, double b) { return {a.re - b, a.v1, a.v2}; }
FEOS_HD D3 operator*(D3 a, D3 b) {
    return {a.re * b.re, a.v1 * b.re + a.re * b.v1,
            a.v2 * b.re + 2.0 * a.v1 * b.v1 + a.re * b.v2};
}
FEOS_HD D3 operator*(D3 a, double b) { return {a.re * b, a.v1 * b, a.v2 * b}; }
FEOS_HD D3 operator*(double a, D3 b) { return {a * b.re, a * b.v1, a * b.v2}; }
// f(x) from f0 = f(x.re), f1 = f'(x.re), f2 = f''(x.re)
FEOS_HD D3 chain(D3 x, double f0, double f1, double f2) {
    return {f0, f1 * x.v1, f2 * x.v1 * x.v1 + f1 * x.v2};
}
FEOS_HD D3 recip(D3 x) {
    const double r = 1.0 / x.re;
    return chain(x, r, -r * r, 2.0 * r * r * r);
}
FEOS_HD D3 operator/(D3 a, D3 b) { return a * recip(b); }
FEOS_HD D3 operator/(D3 a, double b) { return {a.re / b, a.v1 / b, a.v2 / b}; }
FEOS_HD D3 operator/(double a, D3 b) { return a * recip(b); }
FEOS_HD D3 dlog(D3 x) {
    const double r = 1.0 / x.re;
    return chain(x, log(x.re), r, -r * r);
}
FEOS_HD D3 dsqrt(D3 x) {
    const double s = sqrt(x.re);
    return chain(x, s, 0.5 / s, -0.25 / (s * s * s));
}

// phi(rho) for one parameter row par = [m, sigma, epsilon_k, mu, kappa_ab,
// epsilon_k_ab, na, nb] at temperature T.  The density-free row constants
// (feos_tpu's PurePre) are computed here, per element: 2 exp per call.
FEOS_HD D3 phi_pure_d3(const double* par, double T, D3 rho) {
    // universal constants (Gross & Sadowski 2001; Gross & Vrabec 2006),
    // feos_tpu/constants.py; local so that device code may index them
    const double A0[7] = {0.91056314451539, 0.63612814494991, 2.68613478913903,
                          -26.5473624914884, 97.7592087835073, -159.591540865600,
                          91.2977740839123};
    const double A1[7] = {-0.30840169182720, 0.18605311591713, -2.50300472586548,
                          21.4197936296668, -65.2558853303492, 83.3186804808856,
                          -33.7469229297323};
    const double A2[7] = {-0.09061483509767, 0.45278428063920, 0.59627007280101,
                          -1.72418291311787, -4.13021125311661, 13.7766318697211,
                          -8.67284703679646};
    const double B0[7] = {0.72409469413165, 2.23827918609380, -4.00258494846342,
                          -21.00357681484648, 26.8556413626615, 206.5513384066188,
                          -355.60235612207947};
    const double B1[7] = {-0.57554980753450, 0.69950955214436, 3.89256733895307,
                          -17.21547164777212, 192.6722644652495, -161.8264616487648,
                          -165.2076934555607};
    const double B2[7] = {0.09768831158356, -0.25575749816100, -9.15585615297321,
                          20.64207597439724, -38.80443005206285, 93.6267740770146,
                          -29.66690558514725};
    const double AD[5][3] = {{0.30435038064, 0.95346405973, -1.16100802773},
                             {-0.13585877707, -1.83963831920, 4.52586067320},
                             {1.44933285154, 2.01311801180, 0.97512223853},
                             {0.35569769252, -7.37249576667, -12.2810377713},
                             {-2.06533084541, 8.23741345333, 5.93975747420}};
    const double BD[3][3] = {{0.21879385627, -0.58731641193, 3.48695755800},
                             {-1.18964307357, 1.24891317047, -14.9159739347},
                             {1.16268885692, -0.50852797392, 15.3720218600}};
    const double CD[4][3] = {{-0.06467735252, -0.95208758351, -0.62609792333},
                             {0.19758818347, 2.99242575222, 1.29246858189},
                             {-0.80875619458, -2.38026356489, 1.65427830900},
                             {0.69028490492, -0.27012609786, -3.43967436378}};

    const double m = par[0], sigma = par[1], eps_k = par[2], mu = par[3];
    const double kappa_ab = par[4], eps_k_ab = par[5], na = par[6], nb = par[7];

    // row constants (precompute_pure)
    const double d = sigma * (1.0 - 0.12 * exp(-3.0 * eps_k / T));
    const double eta_m = kPi / 6.0 * m * (d * d * d);
    const double e = eps_k / T;
    const double s3 = sigma * sigma * sigma;
    const double m1 = (m - 1.0) / m;
    const double m2 = (m - 2.0) / m;
    const double mu2 = mu * mu / (m * s3 * eps_k) * kMu2Factor;
    const double mu2eff = mu2 * e * s3;
    const double mc = fmin(m, 2.0);
    const double md1 = (mc - 1.0) / mc;
    const double md2 = md1 * (mc - 2.0) / mc;
    const double delta_t = (exp(eps_k_ab / T) - 1.0) * s3 * kappa_ab;

    // density powers (phi_pure_pre)
    const D3 eta = eta_m * rho;
    const D3 eta2 = eta * eta;
    const D3 eta3 = eta2 * eta;
    const D3 eta_m1 = 1.0 / (1.0 - eta);
    const D3 eta_m2 = eta_m1 * eta_m1;
    const D3 etas[7] = {mk(1.0), eta, eta2, eta3, eta2 * eta2, eta2 * eta3, eta3 * eta3};

    // hard sphere
    const D3 hs = m * rho * (4.0 * eta - 3.0 * eta2) * eta_m2;

    // hard chain
    const D3 g = (1.0 - eta / 2.0) * eta_m1 * eta_m2;
    const D3 hc = -rho * (m - 1.0) * dlog(g);

    // dispersion
    D3 I1 = mk(0.0), I2 = mk(0.0);
    for (int i = 0; i < 7; ++i) {
        I1 = I1 + (m1 * (m2 * A2[i] + A1[i]) + A0[i]) * etas[i];
        I2 = I2 + (m1 * (m2 * B2[i] + B1[i]) + B0[i]) * etas[i];
    }
    const D3 C1 = 1.0 / (1.0 + m * (8.0 * eta - 2.0 * eta2) * eta_m2 * eta_m2 +
                         (1.0 - m) *
                             (20.0 * eta - 27.0 * eta2 + 12.0 * eta2 * eta -
                              2.0 * eta2 * eta2) /
                             ((1.0 - eta) * (1.0 - eta) * (2.0 - eta) * (2.0 - eta)));
    const D3 I = 2.0 * I1 + C1 * I2 * (m * e);
    const D3 disp = (-kPi * (m * m * e * s3)) * (rho * rho) * I;

    // dipole: scale-safe Pade phi2 mu2^2 / (1 - r mu2), r = rho (J2/J1) 4pi/3.
    // A J1 of exactly 0 is replaced by the constant 1, whose derivatives are
    // 0, as the torch.where of the plain version does
    D3 J1 = mk(0.0), J2 = mk(0.0);
    for (int i = 0; i < 5; ++i) {
        const double a = AD[i][0] + md1 * AD[i][1] + md2 * AD[i][2];
        const double b = i < 3 ? BD[i][0] + md1 * BD[i][1] + md2 * BD[i][2] : 0.0;
        J1 = J1 + (a + b * e) * etas[i];
    }
    for (int i = 0; i < 4; ++i)
        J2 = J2 + (CD[i][0] + md1 * CD[i][1] + md2 * CD[i][2]) * etas[i];
    const D3 phi2 = -(rho * rho) * J1 * (kPi / s3);
    const D3 J1safe = J1.re != 0.0 ? J1 : mk(1.0);
    const D3 ratio = rho * (J2 / J1safe) * (4.0 / 3.0 * kPi);
    const D3 dipole = phi2 * (mu2eff * mu2eff) / (1.0 - ratio * mu2eff);

    // association (closed-form 2-site); delta_t = 0 gives X = 1, term 0
    const D3 k = eta * eta_m1;
    const D3 delta = (1.0 + k * (1.5 + 0.5 * k)) * eta_m1 * delta_t;
    const D3 rhoa = na * rho;
    const D3 rhob = nb * rho;
    const D3 aux = 1.0 + (rhoa - rhob) * delta;
    const D3 sq = dsqrt(aux * aux + 4.0 * rhob * delta);
    const D3 xa = 2.0 / (sq + 1.0 + (rhob - rhoa) * delta);
    const D3 xb = 2.0 / (sq + 1.0 - (rhob - rhoa) * delta);
    const D3 assoc =
        rhoa * (dlog(xa) - 0.5 * xa + 0.5) + rhob * (dlog(xb) - 0.5 * xb + 0.5);

    return hs + hc + disp + dipole + assoc;
}

// Element i of a (B, k) density batch: row i / k of params (B, 8) and
// temperature (B,); out is (3, B, k) = [phi, phi', phi''].
FEOS_HD void phi_d2_at(const double* params, const double* temperature,
                       const double* rho, double* out, int64_t B, int64_t k,
                       int64_t i) {
    const int64_t row = i / k;
    const int64_t n = B * k;
    const D3 phi = phi_pure_d3(params + 8 * row, temperature[row], D3{rho[i], 1.0, 0.0});
    out[i] = phi.re;
    out[n + i] = phi.v1;
    out[2 * n + i] = phi.v2;
}

}  // namespace feos
