// The pure-component VLE solve of one row, in two stages: the arithmetic of
// the pure_vle kernels (pure_vle.cu), built for the CPU tests by
// pure_vle_host.cpp.
//
// It computes feos_tpu_torch/solvers/vle.py::pure_vle_plain step for step,
// with its constants, for one row:
//
// * The scan (_spinodal_estimate): dp~/drho at the 48 packing fractions of
//   _ETA_GRID (passed in, so that the grid is numpy's to the bit).  Each
//   point is scan_point(); scan_combine() keeps the point torch.argmin
//   picks, and is associative and commutative, so that the kernel reduces a
//   row's points in any tree and gets the serial scan's point.
// * The solve from the scan's result (solve_row): the two-lane liquid NPT
//   solve (targets 1e-10 and p_inf) sharing one counter capped at 60, the
//   ideal-vapor estimate, the one-lane vapor NPT solve, the damped 2x2
//   Newton in (ln rho_V, ln rho_L) with its stall detector, capped at 80,
//   and acceptance from the carried state.  These are one loop that makes
//   one phi evaluation an iteration: the stage and the lane say which
//   density it takes and what the result updates.  So the kernel holds one
//   inlined phi_d3 for the whole solve, and the rows of a warp meet at it
//   whatever stage each is in.  Where the batched torch loop evaluates
//   every lane of an active row and discards the done ones, a row here
//   evaluates only its lanes that are not done; the results are the same.
//
// Every phi evaluation is phi_d3 of pcsaft_pure_d3.cuh on the row's
// constants, computed once.  NaN follows torch: clamps and minima keep a NaN
// (torch.clamp and torch.minimum propagate it where fmin/fmax would drop
// it), and argmin takes the first NaN as the smallest value.
#pragma once

#include "pcsaft_pure_d3.cuh"

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
// (phi, phi', phi'') = (re, v1, 2 v2).  mu~ and its slope cost a log and a
// division, and the scan does not read them: without `with_mu` they are 0.
struct Eos {
    double pt, dpt, mu, dmu;
};

FEOS_HD Eos eos_at(const RowConsts& rc, double rho, bool with_mu) {
    const D3 f = phi_d3(rc, rho);
    const double d2 = 2.0 * f.v2;
    Eos e = {rho - f.re + rho * f.v1, 1.0 + rho * d2, 0.0, 0.0};
    if (with_mu) {
        e.mu = f.v1 + log(rho);
        e.dmu = d2 + 1.0 / rho;
    }
    return e;
}

// -- the scan -----------------------------------------------------------------

// A grid point of the scan: dp~/drho and p~ there, and the point's index
// (rho there is eta_grid[j] / eta_m, recomputed where it is needed).
struct ScanPoint {
    double dpt, pt;
    int j;
};

FEOS_HD double scan_rho(const RowConsts& rc, const double* eta_grid, int j) {
    return eta_grid[j] / rc.eta_m;
}

FEOS_HD ScanPoint scan_point(const RowConsts& rc, const double* eta_grid, int j) {
    const Eos e = eos_at(rc, scan_rho(rc, eta_grid, j), false);
    return {e.dpt, e.pt, j};
}

// The point torch.argmin over dp~/drho keeps of two: a NaN before any
// number, then the smaller value, then the lower index.  A total order on
// distinct indices, so the combine is associative and commutative.
FEOS_HD ScanPoint scan_combine(const ScanPoint& a, const ScanPoint& b) {
    const bool a_nan = isnan(a.dpt), b_nan = isnan(b.dpt);
    bool t;  // a comes first
    if (a_nan != b_nan)
        t = a_nan;
    else if (!a_nan && a.dpt != b.dpt)
        t = a.dpt < b.dpt;
    else
        t = a.j < b.j;
    // field by field: a select of whole structs goes through local memory
    return {t ? a.dpt : b.dpt, t ? a.pt : b.pt, t ? a.j : b.j};
}

// The point every point comes before: the combine's identity, where a
// reduction starts.
FEOS_HD ScanPoint scan_identity() { return {INFINITY, 0.0, kGridSize}; }

// What the solve takes from the scan: p_inf = max(p~, 1e-12) at the
// minimum (NaN kept), rho there, and whether the minimum of dp~/drho is
// positive (no van der Waals loop).
struct Spinodal {
    double p_inf, rho_inf;
    bool supercritical;
};

FEOS_HD Spinodal spinodal_of(const ScanPoint& s, double rho) {
    return {s.pt < 1e-12 ? 1e-12 : s.pt, rho, s.dpt > 0.0};
}

// -- the solve ----------------------------------------------------------------

// An NPT lane p~(rho) = target (_npt_multi_pure), or one phase of the
// Newton: its log density, its target, whether it is done, and its last
// evaluation (the NPT lanes keep p~ and dp~/drho for their acceptance).
// Past the liquid stage lane b's target holds what the next stage needs,
// in place of a register of its own: the vapor stage's fallback for
// ln rho_V, then the Newton's best merit.
struct Lane {
    double lr, target;
    bool done;
    Eos e;
};

FEOS_HD Lane npt_lane(double target, double rho0) {
    // a lane whose target or start is not finite never converges
    return {log(rho0), target, !(isfinite(target) && isfinite(rho0)),
            {INFINITY, 1.0, 0.0, 0.0}};
}

// One NPT step of lane l from its evaluation e at rho = exp(l.lr).
FEOS_HD void npt_step(Lane& l, double rho, const Eos& e, double sign, double lr_max) {
    const double r = e.pt - l.target;
    const double dr = rho * e.dpt;  // d p~ / d ln rho
    const bool pos = dr > 0.0;
    const double newton = r / (pos ? dr : 1.0);
    double step = pos ? clamp_nan(newton, -0.5, 0.5) : -sign * 0.2;
    const bool converged = fabs(newton) < kStepTol && pos;
    const bool bad = !isfinite(step);
    if (bad) step = 0.0;
    if (!(converged || bad)) l.lr = min_nan(l.lr - step, lr_max);
    l.e = e;
    l.done = converged || bad;
}

// The density of a finished NPT lane, and whether it is accepted.
FEOS_HD bool npt_accepted(const Lane& l, double& rho) {
    rho = exp(l.lr);
    const double resid =
        fabs(l.e.pt - l.target) / fabs(rho * (l.e.dpt > 0.0 ? l.e.dpt : 1.0));
    return isfinite(rho) && l.e.dpt > 0.0 && resid < kResRtol;
}

// What the solve reads and never changes: the row constants and two logs.
// The kernel keeps them in shared memory and reads them at each evaluation.
struct SolveConsts {
    RowConsts rc;
    double lr_max;  // log(0.74 / eta_m): the NPT lanes' largest log density
    double ln_inf;  // log(rho_inf): the Newton's bound between the phases
};

FEOS_HD SolveConsts solve_consts(const double* par, double temperature, const Spinodal& sp) {
    SolveConsts c;
    c.rc = row_consts(par, temperature);
    c.lr_max = log(0.74 / c.rc.eta_m);
    c.ln_inf = log(sp.rho_inf);
    return c;
}

// The result of one row's solve, and its work: the NPT iterations (liquid
// and vapor counters added), the Newton iterations and the phi evaluations
// (the scan's 48 included).
struct VleRow {
    double rho_v, rho_l;
    bool ok;
    int npt, newton, evals;
};

enum Stage { kLiquid, kVapor, kNewton, kDone };

// The solve of a row from its scan's result.  `fresh` returns the row's
// SolveConsts for one evaluation: the kernel reads them from shared memory.
template <class Fresh>
FEOS_HD VleRow solve_row(Fresh fresh, const Spinodal& sp) {
    VleRow out;
    out.evals = kGridSize;
    out.npt = 0;

    // _vle_init: lane a is the liquid at vanishing pressure, lane b the
    // liquid at p_inf; then lane a is the vapor NPT lane and b holds the
    // liquid's start; in the Newton a is the vapor, b the liquid
    const double rho_liq = 0.5 / fresh().rc.eta_m;
    Lane a = npt_lane(1e-10, rho_liq), b = npt_lane(sp.p_inf, rho_liq);
    int stage = kLiquid, it = 0;
    bool on_b = false;  // the lane of the next evaluation
    bool ok_l = false;
    int stale = 0;
    for (;;) {
        // an NPT stage ends when its lanes are done or at the cap: the
        // next stage starts (the liquid's and the vapor's may take no
        // evaluation)
        while (stage < kNewton && (it >= kMaxNptIter || (a.done && b.done))) {
            if (stage == kLiquid) {
                double rho0, rho1;
                const bool ok0 = npt_accepted(a, rho0), ok1 = npt_accepted(b, rho1);
                const bool ok_tiny = ok0 && fresh().rc.eta_m * rho0 < 0.7;
                ok_l = ok_tiny || ok1;
                // the ideal-vapor saturation estimate ln p~0 = mu~(rho_L),
                // refined on the vapor branch
                const double mu0 = a.e.mu;
                const double p0 = ok_tiny ? exp(clamp_nan(mu0, -78.0, 78.0)) : sp.p_inf;
                out.npt = it;
                b.lr = log(ok_tiny ? rho0 : rho1);
                b.target = ok_tiny ? mu0 : log(p0 < 1e-300 ? 1e-300 : p0);
                b.done = true;
                a = npt_lane(p0, p0 < 1e-30 ? 1e-30 : p0);
                stage = kVapor;
            } else {
                double rv;
                const bool ok_v = npt_accepted(a, rv);
                a.lr = ok_v && a.target > 1e-33 && rv > 0.0 ? log(rv) : b.target;
                b.target = INFINITY;  // the Newton's best merit
                out.npt += it;
                stage = kNewton;
            }
            it = 0;
        }
        if (stage == kDone) break;
        if (stage < kNewton && !on_b) on_b = a.done;  // an iteration's first lane

        const double lr = on_b ? b.lr : a.lr;
        const double rho = exp(lr);
        const Eos e = eos_at(fresh().rc, rho, true);
        ++out.evals;

        if (stage < kNewton) {
            const double sign = stage == kLiquid ? 1.0 : -1.0;
            const double lr_max = fresh().lr_max;
            if (on_b)
                npt_step(b, rho, e, sign, lr_max);
            else
                npt_step(a, rho, e, sign, lr_max);
            if (!on_b && !b.done) {
                on_b = true;  // lane b in the same iteration
            } else {
                on_b = false;
                ++it;
            }
            continue;
        }
        if (!on_b) {  // the Newton's vapor evaluation: the liquid's next
            a.e = e;
            on_b = true;
            continue;
        }

        // _vle_newton: one damped 2x2 Newton step in (ln rho_V, ln rho_L)
        on_b = false;
        const Eos& ev = a.e;
        const double rho_v = exp(a.lr);
        const double r1 = ev.pt - e.pt;
        const double r2 = ev.mu - e.mu;
        const double j00 = rho_v * ev.dpt;
        const double j01 = -rho * e.dpt;
        const double j10 = rho_v * ev.dmu;
        const double j11 = -rho * e.dmu;
        double det = j00 * j11 - j01 * j10;
        det = fabs(det) > 1e-30 ? det : 1e-30;
        const double dv = (j11 * r1 - j01 * r2) / det;
        const double dl = (-j10 * r1 + j00 * r2) / det;
        // exit on step size or on residuals at the acceptance level
        const double p_allow = kNewtonResRtol * fabs(j00) + kNewtonResAbs * fabs(rho * e.dpt);
        const bool res_ok = fabs(r1) < p_allow && fabs(r2) < kNewtonMuTol;
        // noise-floor stall detection
        const double merit = max_nan(fabs(r1) / p_allow, fabs(r2) / kNewtonMuTol);
        const bool improved = merit < 0.9 * b.target;
        const bool armed = merit < 1e3;
        stale = improved ? 0 : (armed ? stale + 1 : stale);
        b.target = min_nan(b.target, merit);
        const bool stalled = stale >= 3;
        const bool converged = (fabs(dv) + fabs(dl)) < kStepTol || res_ok || stalled;
        double sv = clamp_nan(dv, -0.2, 0.2), sl = clamp_nan(dl, -0.2, 0.2);
        const bool bad = !(isfinite(sv) && isfinite(sl));
        if (bad) sv = sl = 0.0;
        // the final step is taken on the iteration a row converges, unless
        // it stalled
        if (!bad && !stalled) {
            const double ln_inf = fresh().ln_inf;
            a.lr = min_nan(a.lr - sv, ln_inf);
            b.lr = max_nan(b.lr - sl, ln_inf);
        }
        ++it;
        if (converged || bad || it >= kMaxVleIter) {
            // residual acceptance from the carried state (pure_vle_plain)
            out.newton = it;
            out.rho_v = exp(a.lr);
            out.rho_l = exp(b.lr);
            const double p_noise = 4e-12 * fabs(out.rho_l * e.dpt);
            const bool res_p_ok = fabs(r1) < kResRtol * fabs(out.rho_v * ev.dpt) + p_noise;
            out.ok = ok_l && !sp.supercritical && isfinite(out.rho_v) && isfinite(out.rho_l) &&
                     res_p_ok && fabs(r2) < 1e-7 && out.rho_l > out.rho_v * (1.0 + 1e-6) &&
                     ev.dpt > 0.0 && e.dpt > 0.0;
            stage = kDone;
        }
    }
    return out;
}

}  // namespace feos
