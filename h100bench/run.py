"""The benchmark of feos_tpu_torch on one H100: one run of one cell.

    python h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit); the same numbers end
standard error.  Exits non-zero, with no result, without enough CUDA
devices, if the port cannot be imported, or if jax, jaxlib, flax or
feos_tpu got loaded.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    # every build and kernel cache of the program inside the checkout, at
    # fixed paths (the port's own nvcc build lands in build/feos_tpu_torch/)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from h100bench.harness import run

    code, result = run(sys.argv[1:] if argv is None else argv, T_START)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
