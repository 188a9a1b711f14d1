"""The benchmark's own tests, run from the root of a checkout:

    python -m pytest h100bench/tests -q -p no:cacheprovider

They are not part of ``tests/`` and run on the CPU: the harness, its
readers, the reference against the port's CPU path, the control and the
faults, each at a size a test run holds."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
