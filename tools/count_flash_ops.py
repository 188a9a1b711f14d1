"""Count the host (aten) ops of the flash paths on the CPU.

Runs phase 15's cells of ``chip_smoke.py`` at a small batch on the CPU and
counts, with ``torch.profiler``, the aten ops of one call of each: config 6
(config 3's pair at mid-window) without and with gradients, its two edge
solves, one NPT step's pieces (the Q-form phi's pass and the exact phi's
Hessian), and gc config 4 without and with gradients.  The host op count
does not depend on the batch, so it predicts a call's host time on the
card.  With ``--oracle`` it prints instead how many of the ``rows`` rows of
each cell the C++ oracle (``feos_tpu.cpu_backend``) splits at the
mid-window pressures of its own bubble and dew solves: phase 15 requires
every row of both to split.

    python tools/count_flash_ops.py [rows] [--oracle]
"""

import sys
from functools import partial
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from feos_tpu_torch import bubble_point, dew_point, flash  # noqa: E402
from feos_tpu_torch.models.pcsaft_mix import _pre, phi_mix_pre  # noqa: E402
from feos_tpu_torch.solvers.vle import _states_eos, _states_hess  # noqa: E402


def aten_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.name().startswith("aten::"))


def main(rows):
    params, kij, t, x1, p = cs.config6(rows, "cpu")
    stats = {}
    with torch.no_grad():
        n = aten_ops(lambda: flash(params, kij, t, x1, p, stats=stats))
        p0 = torch.full_like(p, 1e5)
        edges = sum(aten_ops(lambda fn=fn: fn(params, kij, t, x1, p0, full_output=True))
                    for fn in (bubble_point, dew_point))
    print(f"config 6 flash: {n} aten ops, loops {stats}; its edge solves {edges}")
    grad = aten_ops(lambda: cs.mix_flash_grad(params, kij, t, x1, p))
    print(f"config 6 flash with gradients: {grad}")
    pre = _pre(params, kij, t)
    z = torch.stack([x1, 1.0 - x1], 1)
    R = torch.stack([z * 0.018, z * 1e-6], 1)
    q = aten_ops(lambda: _states_eos(partial(phi_mix_pre, pre, assoc_q_form=True), R))
    h = aten_ops(lambda: _states_hess(partial(phi_mix_pre, pre), R))
    print(f"one NPT step: Q-form phi pass {q}, exact-phi Hessian {h}")
    _, model, t, x1, p = cs.gc_config4_flash(rows, "cpu")
    stats = {}
    with torch.no_grad():
        n = aten_ops(lambda: model.flash(t, x1, p, stats=stats))
    print(f"gc config 4 flash: {n} aten ops, loops {stats}; with gradients "
          f"{aten_ops(lambda: cs.gc_flash_grad(model, t, x1, p))}")


def oracle(rows):
    import numpy as np

    from feos_tpu import cpu_backend

    params, kij, t, x1, _ = (a.numpy() for a in cs.config6(16, "cpu"))
    params, kij = np.repeat(params[:1], rows, 0), np.repeat(kij[:1], rows, 0)
    t, x1, p0 = np.linspace(140.0, 160.0, rows), np.full(rows, 0.5), np.full(rows, 1e5)
    _, p_bub, _ = cpu_backend.mix_vle_densities(params, kij, t, x1, p0, True)
    _, p_dew, _ = cpu_backend.mix_vle_densities(params, kij, t, x1, p0, False)
    phase = cpu_backend.mix_flash(params, kij, t, x1, np.sqrt(p_bub * p_dew))[4]
    print(f"config 6: the oracle splits {int((phase == 2).sum())} of {rows} rows")
    g = cs.GcSystem(rows).model("cpu").params.detach()
    _, p_bub, _ = cpu_backend.gc_vle_densities(g, t, x1, p0, True)
    _, p_dew, _ = cpu_backend.gc_vle_densities(g, t, x1, p0, False)
    phase = cpu_backend.gc_flash(g, t, x1, np.sqrt(p_bub * p_dew))[4]
    print(f"gc config 4: the oracle splits {int((phase == 2).sum())} of {rows} rows")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--oracle"]
    rows = int(args[0]) if args else 64
    if "--oracle" in sys.argv[1:]:
        oracle(rows)
    else:
        main(rows)
