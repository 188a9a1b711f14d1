"""Readings behind the limits of ``correct``, for one cell, in one process.

    python h100bench/control.py --workload <cell> --seeds 1,2,3

For each seed, on the card: the compared numbers of the reference computed
in float32 put in the program's place (the control, which must fail: the
upper readings), then those of the program's step against the reference
(set-up, warm-up, one kept step, the check: the lower readings).  One JSON
line a seed.  Not part of a benchmark run.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    import argparse

    sys.path.insert(0, str(ROOT))
    import torch

    from h100bench.harness import load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    spec, config, traffic = load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = traffic.Cell(spec, config, seed, device)
        cell.setup()
        line = {"workload": args.workload, "seed": seed,
                "control_float32": cell.control(torch.float32)}
        cell.warm_up()
        cell.begin_window()
        cell.step()
        cell.release()
        line["program"] = cell.check()
        line["limits"] = spec["limits"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
