"""The order in which pytest-xdist hands out the test files of ``tests/``,
and the tests that the tier-1 run leaves out.

The JAX package's few-test files take minutes each; queued last, by
xdist's default of most tests first, they left one worker running for
minutes after the others had finished.  These hooks hand the files out
longest first instead, and mark the tests of ``SLOW_TESTS`` slow
(``tests/_suite_order.py``).
"""

import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "_suite_order", Path(__file__).parent / "tests" / "_suite_order.py"
)
_suite_order = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_suite_order)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: outside the tier-1 run (`-m 'not slow'`)"
    )
    # xdist's loadfile queues files by their number of tests unless told
    # not to (``--no-loadscope-reorder``); the queue then follows the
    # collection order set below
    config.option.loadscopereorder = False


# first, so that pytest's own ``-m`` deselection sees the marks
@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in _suite_order.SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
    items.sort(key=lambda item: _suite_order.rank_of(item.nodeid))
