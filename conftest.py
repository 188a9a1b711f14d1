"""The order in which pytest-xdist hands out the test files of ``tests/``.

The JAX package's few-test files take minutes each; queued last, by
xdist's default of most tests first, they left one worker running for
minutes after the others had finished.  These hooks hand the files out
longest first instead (``tests/_suite_order.py``).
"""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "_suite_order", Path(__file__).parent / "tests" / "_suite_order.py"
)
_suite_order = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_suite_order)


def pytest_configure(config):
    # xdist's loadfile queues files by their number of tests unless told
    # not to (``--no-loadscope-reorder``); the queue then follows the
    # collection order set below
    config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    items.sort(key=lambda item: _suite_order.rank_of(item.nodeid))
