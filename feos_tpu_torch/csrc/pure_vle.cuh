// The pure-component VLE solve of one row: the arithmetic of the pure_vle
// kernel (pure_vle.cu), built for the CPU tests by pure_vle_host.cpp.
//
// It computes feos_tpu_torch/solvers/vle.py::pure_vle_plain step for step,
// with its constants, for one row: the spinodal scan on the 48 packing
// fractions of _ETA_GRID (passed in, so that the grid is numpy's to the
// bit), the two-lane liquid NPT solve (targets 1e-10 and p_inf) sharing one
// counter capped at 60, the ideal-vapor estimate, the one-lane vapor NPT
// solve, the damped 2x2 Newton in (ln rho_V, ln rho_L) with its stall
// detector, capped at 80, and acceptance from the carried state.  Every
// phi evaluation is phi_d3 of pcsaft_pure_d3.cuh on the row's constants,
// computed once.  Where the batched torch loop evaluates every lane of an
// active row and discards the done ones, a row here evaluates only its
// lanes that are not done; the results are the same.
//
// NaN follows torch: clamps and minima keep a NaN (torch.clamp and
// torch.minimum propagate it where fmin/fmax would drop it), and argmin
// takes the first NaN as the smallest value.
#pragma once

#include "pcsaft_pure_d3.cuh"

// a loop over lanes stays a loop: one inlined phi_d3 for all its lanes
#ifdef __CUDACC__
#define FEOS_NO_UNROLL _Pragma("unroll 1")
#else
#define FEOS_NO_UNROLL
#endif

namespace feos {

constexpr int kGridSize = 48;      // _ETA_GRID
constexpr int kMaxNptIter = 60;    // _MAX_NPT_ITER
constexpr int kMaxVleIter = 80;    // _MAX_VLE_ITER
constexpr double kStepTol = 3e-12;          // _STEP_TOL
constexpr double kResRtol = 1e-6;           // _RES_RTOL
constexpr double kNewtonResRtol = 1e-9;     // _NEWTON_RES_RTOL
constexpr double kNewtonResAbs = 1e-12;     // _NEWTON_RES_ABS
constexpr double kNewtonMuTol = 1e-9;       // _NEWTON_MU_TOL

// torch.clamp(x, lo, hi), torch.minimum and torch.maximum: NaN in, NaN out
FEOS_HD double clamp_nan(double x, double lo, double hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}
FEOS_HD double min_nan(double a, double b) {
    return isnan(a) || isnan(b) ? a + b : (a < b ? a : b);
}
FEOS_HD double max_nan(double a, double b) {
    return isnan(a) || isnan(b) ? a + b : (a > b ? a : b);
}

// (p~, dp~/drho, mu~_tot, dmu~/drho) at rho: _eos_pure_multi on phi_d2's
// (phi, phi', phi'') = (re, v1, 2 v2)
struct Eos {
    double pt, dpt, mu, dmu;
};

FEOS_HD Eos eos_at(const RowConsts& rc, double rho) {
    const D3 f = phi_d3(rc, rho);
    const double d2 = 2.0 * f.v2;
    return {rho - f.re + rho * f.v1, 1.0 + rho * d2, f.v1 + log(rho), d2 + 1.0 / rho};
}

// The result of one row's solve, and its work: the NPT iterations (liquid
// and vapor counters added), the Newton iterations and the phi evaluations.
struct VleRow {
    double rho_v, rho_l;
    bool ok;
    int npt, newton, evals;
};

// K NPT lanes p~(rho) = target of one row (_npt_multi_pure): lanes share
// the row's counter and freeze one by one; each keeps its last evaluated
// (p~, dp~/drho, mu~).  Returns the iterations; rho, ok and mu per lane.
template <int K>
FEOS_HD int npt_lanes(const RowConsts& rc, const double (&target)[K],
                      const double (&rho0)[K], double sign, double lr_max,
                      double (&rho)[K], bool (&ok)[K], double (&mu)[K], int& evals) {
    double lr[K], keep_pt[K], keep_dpt[K];
    bool done[K];
    for (int l = 0; l < K; ++l) {
        lr[l] = log(rho0[l]);
        keep_pt[l] = INFINITY;
        keep_dpt[l] = 1.0;
        mu[l] = 0.0;
        // a lane whose target or start is not finite never converges
        done[l] = !(isfinite(target[l]) && isfinite(rho0[l]));
    }
    int it = 0;
    while (it < kMaxNptIter) {
        bool active = false;
        for (int l = 0; l < K; ++l) active = active || !done[l];
        if (!active) break;
FEOS_NO_UNROLL
        for (int l = 0; l < K; ++l) {
            if (done[l]) continue;
            const double r_l = exp(lr[l]);
            const Eos e = eos_at(rc, r_l);
            ++evals;
            const double r = e.pt - target[l];
            const double dr = r_l * e.dpt;  // d p~ / d ln rho
            const bool pos = dr > 0.0;
            const double newton = r / (pos ? dr : 1.0);
            double step = pos ? clamp_nan(newton, -0.5, 0.5) : -sign * 0.2;
            const bool converged = fabs(newton) < kStepTol && pos;
            const bool bad = !isfinite(step);
            if (bad) step = 0.0;
            if (!(converged || bad)) lr[l] = min_nan(lr[l] - step, lr_max);
            keep_pt[l] = e.pt;
            keep_dpt[l] = e.dpt;
            mu[l] = e.mu;
            done[l] = converged || bad;
        }
        ++it;
    }
    for (int l = 0; l < K; ++l) {
        rho[l] = exp(lr[l]);
        const double resid =
            fabs(keep_pt[l] - target[l]) / fabs(rho[l] * (keep_dpt[l] > 0.0 ? keep_dpt[l] : 1.0));
        ok[l] = isfinite(rho[l]) && keep_dpt[l] > 0.0 && resid < kResRtol;
    }
    return it;
}

// The whole solve of the row par at temperature T; eta_grid holds the 48
// packing fractions of the spinodal scan.
FEOS_HD VleRow pure_vle_row(const double* par, double temperature, const double* eta_grid) {
    const RowConsts rc = row_consts(par, temperature);
    const double eta_m = rc.eta_m;
    VleRow out;
    out.evals = 0;

    // _spinodal_estimate: the grid point of least dp~/drho
    double p_min = 0.0, d_min = INFINITY, rho_min = 0.0;
    bool nan_min = false;
FEOS_NO_UNROLL
    for (int j = 0; j < kGridSize; ++j) {
        const double rho = eta_grid[j] / eta_m;
        const Eos e = eos_at(rc, rho);
        ++out.evals;
        const bool take = !nan_min && (isnan(e.dpt) || e.dpt < d_min || j == 0);
        if (take) {
            nan_min = isnan(e.dpt);
            d_min = e.dpt;
            p_min = e.pt;
            rho_min = rho;
        }
    }
    const bool supercritical = d_min > 0.0;
    const double p_inf = p_min < 1e-12 ? 1e-12 : p_min;
    const double ln_inf = log(rho_min);

    // _vle_init, lane 0: liquid at vanishing pressure; lane 1: at p_inf
    const double rho_liq = 0.5 / eta_m;
    const double lr_max = log(0.74 / eta_m);
    double rho_init[2], mu_init[2];
    bool ok_init[2];
    const int n_liq = npt_lanes<2>(rc, {1e-10, p_inf}, {rho_liq, rho_liq}, 1.0, lr_max,
                                   rho_init, ok_init, mu_init, out.evals);
    const bool ok_tiny = ok_init[0] && eta_m * rho_init[0] < 0.7;
    const double rho_l0 = ok_tiny ? rho_init[0] : rho_init[1];
    const bool ok_l = ok_tiny || ok_init[1];

    // the ideal-vapor saturation estimate ln p~0 = mu~(rho_L), refined on
    // the vapor branch
    const double mu0 = mu_init[0];
    const double p_mu = exp(clamp_nan(mu0, -78.0, 78.0));
    const double p0 = ok_tiny ? p_mu : p_inf;
    double rho_vap[1], mu_vap[1];
    bool ok_vap[1];
    const int n_vap = npt_lanes<1>(rc, {p0}, {p0 < 1e-30 ? 1e-30 : p0}, -1.0, lr_max,
                                   rho_vap, ok_vap, mu_vap, out.evals);
    const double rv = rho_vap[0];
    double ln_rho_v0;
    if (ok_vap[0] && p0 > 1e-33 && rv > 0.0)
        ln_rho_v0 = log(rv);
    else
        ln_rho_v0 = ok_tiny ? mu0 : log(p0 < 1e-300 ? 1e-300 : p0);
    out.npt = n_liq + n_vap;

    // _vle_newton: damped 2x2 Newton in (ln rho_V, ln rho_L)
    double lv = ln_rho_v0, ll = log(rho_l0);
    double r_p = INFINITY, r_mu = INFINITY, dpt_v = INFINITY, dpt_l = INFINITY;
    double best = INFINITY;
    int stale = 0, it = 0;
    bool done = false;
    while (!done && it < kMaxVleIter) {
        const double rho[2] = {exp(lv), exp(ll)};
        Eos e[2];
FEOS_NO_UNROLL
        for (int l = 0; l < 2; ++l) e[l] = eos_at(rc, rho[l]);
        out.evals += 2;
        const double r1 = e[0].pt - e[1].pt;
        const double r2 = e[0].mu - e[1].mu;
        const double j00 = rho[0] * e[0].dpt;
        const double j01 = -rho[1] * e[1].dpt;
        const double j10 = rho[0] * e[0].dmu;
        const double j11 = -rho[1] * e[1].dmu;
        double det = j00 * j11 - j01 * j10;
        det = fabs(det) > 1e-30 ? det : 1e-30;
        const double dv = (j11 * r1 - j01 * r2) / det;
        const double dl = (-j10 * r1 + j00 * r2) / det;
        // exit on step size or on residuals at the acceptance level
        const double p_allow = kNewtonResRtol * fabs(j00) + kNewtonResAbs * fabs(rho[1] * e[1].dpt);
        const bool res_ok = fabs(r1) < p_allow && fabs(r2) < kNewtonMuTol;
        // noise-floor stall detection
        const double merit = max_nan(fabs(r1) / p_allow, fabs(r2) / kNewtonMuTol);
        const bool improved = merit < 0.9 * best;
        const bool armed = merit < 1e3;
        stale = improved ? 0 : (armed ? stale + 1 : stale);
        best = min_nan(best, merit);
        const bool stalled = stale >= 3;
        const bool converged = (fabs(dv) + fabs(dl)) < kStepTol || res_ok || stalled;
        double sv = clamp_nan(dv, -0.2, 0.2), sl = clamp_nan(dl, -0.2, 0.2);
        const bool bad = !(isfinite(sv) && isfinite(sl));
        if (bad) sv = sl = 0.0;
        // the final step is taken on the iteration a row converges, unless
        // it stalled
        if (!bad && !stalled) {
            lv = min_nan(lv - sv, ln_inf);
            ll = max_nan(ll - sl, ln_inf);
        }
        r_p = r1;
        r_mu = r2;
        dpt_v = e[0].dpt;
        dpt_l = e[1].dpt;
        done = converged || bad;
        ++it;
    }
    out.newton = it;

    // residual acceptance from the carried state (pure_vle_plain)
    out.rho_v = exp(lv);
    out.rho_l = exp(ll);
    const double p_noise = 4e-12 * fabs(out.rho_l * dpt_l);
    const bool res_p_ok = fabs(r_p) < kResRtol * fabs(out.rho_v * dpt_v) + p_noise;
    out.ok = ok_l && !supercritical && isfinite(out.rho_v) && isfinite(out.rho_l) && res_p_ok &&
             fabs(r_mu) < 1e-7 && out.rho_l > out.rho_v * (1.0 + 1e-6) && dpt_v > 0.0 &&
             dpt_l > 0.0;
    return out;
}

}  // namespace feos
