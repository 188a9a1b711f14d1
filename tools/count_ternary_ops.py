"""Count the host (aten) ops of phase 16's ternary paths on the CPU.

Runs the cells of ``chip_smoke.py``'s phase 16 at a small batch on the CPU
and counts, with ``torch.profiler``, the aten ops of one call of each:
bubble and dew with the backward of sum ln p for (a) the non-associating
ternary, (b) the cross-associating ternary [inert, A, B], (c) the gc
ternary, and config 3's binary bubble call of phase 12 beside them; then
the bubble temperature and the flash (without and with gradients) of (a)
and (c).  The host op count does not depend on the batch, so it predicts a
call's host time on the card.

    python tools/count_ternary_ops.py [rows]
"""

import sys
from functools import partial
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from feos_tpu_torch import bubble_point  # noqa: E402


def aten_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.name().startswith("aten::"))


def main(rows):
    torch.cuda.synchronize = lambda *a, **k: None  # on_card's, on the CPU
    cells = {
        "(a)": cs.Ternary("mix", rows, cs.TERNARY_Z, 180.0, 200.0, cs.TERNARY),
        "(b)": cs.Ternary("mix", rows, cs.CROSS_Z, 140.0, 160.0, cs.CROSS_TERNARY),
        "(c)": cs.Ternary("gc", rows, cs.TERNARY_Z, 230.0, 250.0),
    }
    p = {}
    for tag, cell in cells.items():
        for name in ("bubble", "dew"):
            stats = {}
            run = partial(cs.ternary_run, name, *cell.args("cpu"), stats=stats)
            print(f"{tag} {name} + backward: {aten_ops(run)} aten ops, loops {stats}",
                  flush=True)
            p[tag, name] = run()[1][0]
    args = (cs.f64(np.tile(cs.CONFIG3, (rows, 1, 1)), "cpu"),
            cs.f64(np.tile(cs.CONFIG3_KIJ, (rows, 1)), "cpu"),
            cs.f64(np.linspace(140.0, 160.0, rows), "cpu"), cs.f64(np.full(rows, 0.5), "cpu"),
            cs.f64(np.full(rows, 1e5), "cpu"))
    stats = {}
    n = aten_ops(lambda: cs.mixture_run(bubble_point, *args, stats=stats))
    print(f"config 3 bubble + backward (phase 12): {n} aten ops, loops {stats}", flush=True)
    for tag in ("(a)", "(c)"):
        cell = cells[tag]
        label = f"{tag} bubble T"
        n = aten_ops(lambda: cs.ternary_temperature(label, cell, "cpu", p[tag, "bubble"]))
        print(f"{label} + backward: {n} aten ops", flush=True)
        n = aten_ops(lambda: cs.ternary_flash(f"{tag} flash", cell, "cpu", p[tag, "bubble"],
                                              p[tag, "dew"]))
        print(f"{tag} flash, without and with gradients, and its consistency check: "
              f"{n} aten ops", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
