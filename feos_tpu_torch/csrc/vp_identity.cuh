// The vapor-pressure identity and its partials, per row, by a hand-written
// adjoint in plain scalars: the arithmetic of the vp_identity kernel
// (vp_identity.cu), built for the CPU tests by vp_identity_host.cpp and
// counted by vp_identity_ops.cpp.
//
// At converged coexisting densities (rho_V, rho_L) the reduced pressure is
//
//   p~ = -(a_V - a_L + ln(rho_V / rho_L)) / D,   D = 1/rho_V - 1/rho_L,
//   a = phi(rho) / rho,
//
// which is stationary in both densities, so its partials in the 8
// parameters and T at fixed densities are the implicit-function derivative
// of the solve (feos_tpu/models/pcsaft_pure.py::vapor_pressure.attach).
//
// p~ is linear in phi_V and phi_L, with the weights -1/(D rho_V) and
// 1/(D rho_L), which do not depend on phi.  So one pass at each density
// (phi_pass) computes phi and adds the weight times phi's partials in the
// row quantities it reads (RowQ) to their adjoints; row_adjoint then takes
// the row stage back to the 8 parameters and T.  Within a pass each term's
// adjoint follows its value, and only eta's adjoint is carried from term to
// term.
//
// RowQ holds 14 quantities, not the 32 row constants of pcsaft_pure_d3.cuh:
// the 23 polynomial coefficients there are linear in (m1, m2) (dispersion)
// and in (md1, md2, e) (dipole).  A pass evaluates the polynomials of the
// universal constants at eta instead, so that neither a coefficient nor its
// adjoint is held: the 14 quantities, their 14 adjoints and a pass's
// intermediates fit in registers.
//
// phi follows the plain graph (feos_tpu_torch/models/pcsaft_pure.py::
// phi_pure_pre) term for term.  Its association is always the two-site
// form: the one-root form that phi_d3 takes for na = nb sees only
// rho_a = na rho, so its na and nb partials would be wrong.  A term is
// skipped only where it is zero with all its partials: the dipole where
// mu2eff = 0 (the term goes as mu2eff^2), the association where kappa_ab =
// eps_ab = 0 (a row with kappa_ab > 0 and eps_ab = 0 has no association
// strength and still an eps_ab partial, and one with kappa_ab = 0 and
// eps_ab > 0 a kappa_ab partial).
//
// The scalar R is double except where vp_identity_ops.cpp counts the
// operations.
#pragma once

#include "pcsaft_pure_d3.cuh"

#ifdef __CUDACC__
#define FEOS_UNROLL _Pragma("unroll")
#else
#define FEOS_UNROLL
#endif

namespace feos {

// The row quantities phi reads, or their adjoints.
template <class R>
struct RowQ {
    R m, eta_m, m1, m2, md1, md2, e, me, m2es3, inv_s3, mu2eff, delta_t, na, nb;
};

// The row stage of precompute_pure for par = [m, sigma, epsilon_k, mu,
// kappa_ab, epsilon_k_ab, na, nb] at T, as row_consts computes it, and its
// two exponentials, which its adjoint reuses (the adjoint recomputes the
// rest, so that the passes carry fewer registers).
template <class R>
struct Row {
    RowQ<R> q;
    R x3, ex;        // exp(-3e), exp(eps_ab/T)
    bool md_free;    // m <= 2: md1 and md2 vary with m
    bool dipole, assoc;  // the terms phi takes
};

template <class R>
FEOS_HD Row<R> row_of(const double* par, double temperature) {
    const R m = par[0], sigma = par[1], eps_k = par[2], mu = par[3];
    const R kappa_ab = par[4], eps_k_ab = par[5];
    Row<R> r;
    RowQ<R>& q = r.q;
    const R inv_t = 1.0 / R(temperature);
    q.e = eps_k * inv_t;
    const R s3 = sigma * sigma * sigma;
    const R inv_m = 1.0 / m;
    q.m1 = (m - 1.0) * inv_m;
    q.m2 = (m - 2.0) * inv_m;
    const R mc = fmin(m, R(2.0));
    const R inv_mc = 1.0 / mc;
    q.md1 = (mc - 1.0) * inv_mc;
    q.md2 = q.md1 * (mc - 2.0) * inv_mc;
    r.x3 = exp(-3.0 * q.e);
    const R d = sigma * (1.0 - 0.12 * r.x3);
    q.m = m;
    q.eta_m = kPi / 6.0 * m * (d * d * d);
    q.me = m * q.e;
    q.m2es3 = m * q.me * s3;
    q.inv_s3 = 1.0 / s3;
    q.mu2eff = mu * mu * inv_m * inv_t * kMu2Factor;
    r.ex = exp(eps_k_ab * inv_t);
    q.delta_t = (r.ex - 1.0) * s3 * kappa_ab;
    q.na = par[6];
    q.nb = par[7];
    r.md_free = m <= 2.0;  // torch.clamp(m, max=2) passes the gradient there
    r.dipole = q.mu2eff != 0.0;
    r.assoc = kappa_ab != 0.0 || eps_k_ab != 0.0;
    return r;
}

// p(x) = sum_i c[i] x^i and p'(x), by Horner's rule; `stride` steps
// through a column of a table.
template <int N, class R>
FEOS_HD void horner(const double* c, int stride, R x, R& p, R& dp) {
    p = c[(N - 1) * stride];
    dp = 0.0;
    FEOS_UNROLL
    for (int i = N - 2; i >= 0; --i) {
        dp = dp * x + p;
        p = p * x + c[i * stride];
    }
}

// A polynomial in eta whose coefficients are linear in two row quantities
// u and v, built from the polynomials p_k of a table's k-th coefficients:
// its value, its slope in eta and its partials in u and v.
template <class R>
struct Poly2 {
    R p, dp, du, dv;
};

// the dispersion's I = a_0 + m1 (a_1 + m2 a_2): u = m1, v = m2
template <class R>
FEOS_HD Poly2<R> dispersion_poly(const double (&c)[3][7], R x, R m1, R m2) {
    R p0, d0, p1, d1, p2, d2;
    horner<7>(c[2], 1, x, p2, d2);
    horner<7>(c[1], 1, x, p1, d1);
    const R q1 = p1 + m2 * p2;
    Poly2<R> out;
    out.du = q1;
    out.dv = m1 * p2;
    horner<7>(c[0], 1, x, p0, d0);
    out.p = p0 + m1 * q1;
    out.dp = d0 + m1 * (d1 + m2 * d2);
    return out;
}

// a dipole integral sum_i c[i].(1, md1, md2) eta^i: u = md1, v = md2
template <int N, class R>
FEOS_HD Poly2<R> dipole_poly(const double (&c)[N][3], R x, R md1, R md2) {
    R p0, d0, p1, d1, p2, d2;
    horner<N>(&c[0][1], 3, x, p1, d1);
    horner<N>(&c[0][2], 3, x, p2, d2);
    Poly2<R> out;
    out.du = p1;
    out.dv = p2;
    horner<N>(&c[0][0], 3, x, p0, d0);
    out.p = p0 + md1 * p1 + md2 * p2;
    out.dp = d0 + md1 * d1 + md2 * d2;
    return out;
}

// phi at rho from the row r, and w times its partials in r.q added to bar.
template <class R>
FEOS_HD R phi_pass(const Row<R>& r, double rho, double w, RowQ<R>& bar) {
    const Universal u = universal();
    const RowQ<R>& q = r.q;
    const R x = q.eta_m * rho;  // eta
    const R x2 = x * x;
    const R i1 = 1.0 / (1.0 - x);
    const R i2 = i1 * i1;
    const R it = 1.0 / (2.0 - x);

    // hard sphere: m rho h, h = (4 eta - 3 eta^2) / (1 - eta)^2
    const R h = (4.0 * x - 3.0 * x2) * i2;
    R phi = q.m * rho * h;
    R mb = w * rho * h;
    R xb = w * q.m * rho * ((4.0 - 6.0 * x) * i2 + 2.0 * h * i1);  // w d phi / d eta

    // hard chain: -rho (m - 1) log g, g = (1 - eta/2) / (1 - eta)^3
    const R lg = log((1.0 - x / 2.0) * i1 * i2);
    phi = phi - rho * (q.m - 1.0) * lg;
    mb = mb - w * rho * lg;
    xb = xb - w * rho * (q.m - 1.0) * (3.0 * i1 - it);

    // dispersion: -pi rho^2 m2es3 (2 I1 + C1 I2 me), with I1 = p0 + m1 (p1 +
    // m2 p2) for the polynomials p_k of a_k at eta (I2 the same of b_k)
    const Poly2<R> I1 = dispersion_poly(u.a, x, q.m1, q.m2);
    const Poly2<R> I2 = dispersion_poly(u.b, x, q.m1, q.m2);
    // C1 = 1 / (1 + m P + (1 - m) Q)
    const R P = (8.0 * x - 2.0 * x2) * i2 * i2;
    const R dP = (8.0 - 4.0 * x) * i2 * i2 + 4.0 * P * i1;
    const R uq = i2 * it * it;  // 1 / ((1 - eta)^2 (2 - eta)^2)
    const R Q = (20.0 * x - 27.0 * x2 + 12.0 * x2 * x - 2.0 * x2 * x2) * uq;
    const R dQ = (20.0 - 54.0 * x + 36.0 * x2 - 8.0 * x2 * x) * uq + 2.0 * Q * (i1 + it);
    const R C1 = 1.0 / (1.0 + q.m * P + (1.0 - q.m) * Q);
    const R I = 2.0 * I1.p + C1 * I2.p * q.me;
    const double K = -kPi * rho * rho;
    phi = phi + K * q.m2es3 * I;
    bar.m2es3 = bar.m2es3 + w * K * I;
    const R Ib = w * K * q.m2es3;
    const R C1me = C1 * q.me;
    const R Dnb = -Ib * I2.p * q.me * C1 * C1;  // adjoint of C1's denominator
    mb = mb + Dnb * (P - Q);
    xb = xb + Ib * (2.0 * I1.dp + C1me * I2.dp) + Dnb * (q.m * dP + (1.0 - q.m) * dQ);
    bar.me = bar.me + Ib * C1 * I2.p;
    bar.m1 = bar.m1 + Ib * (2.0 * I1.du + C1me * I2.du);
    bar.m2 = bar.m2 + Ib * (2.0 * I1.dv + C1me * I2.dv);

    // dipole: the scale-safe Pade phi2 mu2^2 / (1 - ratio mu2), phi2 = -pi
    // rho^2 J1 / sigma^3, ratio = rho (J2/J1) 4pi/3 (a J1 of exactly 0 is 1
    // there, as the torch.where of the plain graph has it); J1 = sum over
    // i < 5 of (ad_i + e bd_i).(1, md1, md2) eta^i (bd_i = 0 for i >= 3),
    // J2 = sum over i < 4 of cd_i.(1, md1, md2) eta^i
    if (r.dipole) {
        // J1 = Ja + e Jb over the tables ad and bd, J2 over cd
        const Poly2<R> Ja = dipole_poly(u.ad, x, q.md1, q.md2);
        const Poly2<R> Jb = dipole_poly(u.bd, x, q.md1, q.md2);
        const R J1 = Ja.p + q.e * Jb.p;
        const R dJ1 = Ja.dp + q.e * Jb.dp;
        const Poly2<R> J2 = dipole_poly(u.cd, x, q.md1, q.md2);
        const R mu = q.mu2eff;
        const R phi2 = -rho * rho * J1 * q.inv_s3 * kPi;
        const bool j1_zero = J1 == 0.0;
        const R inv_j1 = 1.0 / (j1_zero ? R(1.0) : J1);
        const R ratio = rho * (J2.p * inv_j1) * (4.0 / 3.0 * kPi);
        const R iN = 1.0 / (1.0 - ratio * mu);
        phi = phi + phi2 * mu * mu * iN;
        const R phi2b = w * mu * mu * iN;
        const R ratiob = w * phi2 * mu * mu * mu * iN * iN;
        // d/dmu of mu^2 / (1 - ratio mu) = mu (2 - ratio mu) / (1 - ratio mu)^2
        bar.mu2eff = bar.mu2eff + w * phi2 * mu * (2.0 - ratio * mu) * iN * iN;
        bar.inv_s3 = bar.inv_s3 - phi2b * rho * rho * J1 * kPi;
        const R J2b = ratiob * rho * (4.0 / 3.0 * kPi) * inv_j1;
        R J1b = -phi2b * rho * rho * q.inv_s3 * kPi;
        if (!j1_zero) J1b = J1b - ratiob * ratio * inv_j1;
        xb = xb + J1b * dJ1 + J2b * J2.dp;
        bar.e = bar.e + J1b * Jb.p;
        if (r.md_free) {
            bar.md1 = bar.md1 + J1b * (Ja.du + q.e * Jb.du) + J2b * J2.du;
            bar.md2 = bar.md2 + J1b * (Ja.dv + q.e * Jb.dv) + J2b * J2.dv;
        }
    }

    // association, the two-site closed form X_A = 2/da, X_B = 2/db at
    // rho_a = na rho, rho_b = nb rho and delta = D(eta) delta_t
    if (r.assoc) {
        const R k = x * i1;
        const R F = 1.0 + k * (1.5 + 0.5 * k);
        const R dl = F * i1;  // D(eta)
        const R delta = dl * q.delta_t;
        const R rhoa = q.na * rho, rhob = q.nb * rho;
        const R aux = 1.0 + (rhoa - rhob) * delta;
        const R sq = sqrt(aux * aux + 4.0 * rhob * delta);
        const R v = (rhob - rhoa) * delta;
        const R da_ = sq + 1.0 + v, db_ = sq + 1.0 - v;
        const R xa = 2.0 / da_, xb_ = 2.0 / db_;
        const R fa = log(xa) - 0.5 * xa + 0.5, fb = log(xb_) - 0.5 * xb_ + 0.5;
        phi = phi + (rhoa * fa + rhob * fb);
        // d f / d x_a = rho_a (1/x_a - 1/2) = rho_a (da - 1)/2, and
        // d x_a / d da = -x_a^2 / 2
        const R dab = -0.25 * w * rhoa * (da_ - 1.0) * xa * xa;
        const R dbb = -0.25 * w * rhob * (db_ - 1.0) * xb_ * xb_;
        const R sb = (dab + dbb) * 0.5 / sq;  // adjoint of the root's argument
        const R vb = dab - dbb;
        const R auxb = 2.0 * sb * aux;
        const R deltab = 4.0 * sb * rhob + vb * (rhob - rhoa) + auxb * (rhoa - rhob);
        bar.na = bar.na + rho * (w * fa + (auxb - vb) * delta);
        bar.nb = bar.nb + rho * (w * fb + (4.0 * sb + vb - auxb) * delta);
        bar.delta_t = bar.delta_t + deltab * dl;
        // D'(eta) = (F'(k) / (1 - eta) + F) / (1 - eta)^2, k'(eta) = 1 / (1 - eta)^2
        xb = xb + deltab * q.delta_t * ((1.5 + k) * i1 + F) * i2;
    }

    bar.m = bar.m + mb;
    bar.eta_m = bar.eta_m + xb * rho;
    return phi;
}

// The adjoint of the row stage: the partials in [m, sigma, epsilon_k, mu,
// kappa_ab, epsilon_k_ab, na, nb, T] from the adjoints b of the row
// quantities.
template <class R>
FEOS_HD void row_adjoint(const double* par, double temperature, const Row<R>& r,
                         const RowQ<R>& b, R* out) {
    const R m = par[0], sigma = par[1], eps_k = par[2], mu = par[3];
    const R kappa_ab = par[4], eps_k_ab = par[5];
    const RowQ<R>& q = r.q;
    const R inv_t = 1.0 / R(temperature);
    const R s3 = sigma * sigma * sigma;
    const R inv_m = 1.0 / m;  // 1/mc too where md_free
    const R d = sigma * (1.0 - 0.12 * r.x3);
    // m2es3 = m me s3, me = m e
    const R meb = b.me + b.m2es3 * m * s3;
    R mb = b.m + b.m2es3 * q.me * s3 + meb * q.e;
    R eb = b.e + meb * m;
    R s3b = b.m2es3 * m * q.me - b.inv_s3 * q.inv_s3 * q.inv_s3;
    // eta_m = pi/6 m d^3, d = sigma (1 - 0.12 exp(-3e))
    const R d2 = d * d;
    mb = mb + b.eta_m * (kPi / 6.0) * d2 * d;
    const R db = b.eta_m * (kPi / 2.0) * m * d2;
    R sigmab = db * (1.0 - 0.12 * r.x3);
    eb = eb + db * sigma * 0.36 * r.x3;
    // m1 = (m - 1)/m, m2 = (m - 2)/m; md1 = (mc - 1)/mc, md2 = (mc - 1)(mc -
    // 2)/mc^2 with mc = m where m <= 2
    mb = mb + (b.m1 + 2.0 * b.m2) * inv_m * inv_m;
    if (r.md_free) mb = mb + (b.md1 + b.md2 * (3.0 * m - 4.0) * inv_m) * inv_m * inv_m;
    // mu2eff = mu^2 MU2_FACTOR / (m T)
    mb = mb - b.mu2eff * q.mu2eff * inv_m;
    R inv_tb = b.mu2eff * q.mu2eff * R(temperature);
    const R mub = b.mu2eff * 2.0 * mu * inv_m * inv_t * kMu2Factor;
    // delta_t = (exp(eps_ab/T) - 1) sigma^3 kappa_ab
    const R kappab = b.delta_t * (r.ex - 1.0) * s3;
    s3b = s3b + b.delta_t * (r.ex - 1.0) * kappa_ab;
    const R exb = b.delta_t * s3 * kappa_ab * r.ex;  // adjoint of eps_ab/T
    inv_tb = inv_tb + exb * eps_k_ab + eb * eps_k;
    sigmab = sigmab + s3b * 3.0 * sigma * sigma;
    out[0] = mb;
    out[1] = sigmab;
    out[2] = eb * inv_t;
    out[3] = mub;
    out[4] = kappab;
    out[5] = exb * inv_t;
    out[6] = b.na;
    out[7] = b.nb;
    out[8] = -inv_tb * inv_t * inv_t;
}

// The partials: the 8 parameters, then T.
constexpr int kPartials = 9;

// p~ and its partials (9) in the parameters and T of one row at fixed
// (rho_v, rho_l).
template <class R = double>
FEOS_HD void vp_identity_row(const double* par, double temperature, double rho_v,
                             double rho_l, R* ptilde, R* partials) {
    const Row<R> r = row_of<R>(par, temperature);
    const double D = 1.0 / rho_v - 1.0 / rho_l;
    RowQ<R> bar = {};
    const R phi_l = phi_pass(r, rho_l, 1.0 / (D * rho_l), bar);
    const R phi_v = phi_pass(r, rho_v, -1.0 / (D * rho_v), bar);
    *ptilde = -(phi_v / rho_v - phi_l / rho_l + log(rho_v / rho_l)) / D;
    row_adjoint(par, temperature, r, bar, partials);
}

}  // namespace feos
