"""The suite's longest-first file order and its slow tests
(``tests/_suite_order.py`` and the root ``conftest.py``)."""

import ast
import importlib.util
from pathlib import Path

from _suite_order import SLOW_FILES, SLOW_TESTS, rank_of

_ROOT = Path(__file__).resolve().parent.parent


def _file(nodeid):
    return nodeid.split("::", 1)[0].rsplit("/", 1)[-1]


def test_slow_files_first_in_listed_order_rest_in_place():
    # every listed file collected in reverse, each after a file not listed
    # and split in two by it
    collected = []
    for i, name in enumerate(reversed(SLOW_FILES)):
        collected += [
            f"tests/test_other_{i}.py::test_a",
            f"tests/{name}::test_x",
            f"tests/test_other_{i}.py::Group::test_b[1]",
            f"tests/{name}::test_y[0]",
        ]
    ordered = sorted(collected, key=rank_of)

    assert sorted(ordered) == sorted(collected)
    n = 2 * len(SLOW_FILES)
    # each listed file before every other file, in the listed order
    assert [_file(x) for x in ordered[:n:2]] == list(SLOW_FILES)
    # a file's tests keep their order
    assert ordered[:n] == [
        f"tests/{name}::test_{t}" for name in SLOW_FILES for t in ("x", "y[0]")
    ]
    # files not listed keep their collection order, and so do their tests
    assert ordered[n:] == [x for x in collected if "test_other_" in x]


class _Item:
    def __init__(self, nodeid):
        self.nodeid = nodeid
        self.marks = []

    def add_marker(self, mark):
        self.marks.append(mark.name)


def test_hook_marks_exactly_the_slow_tests():
    spec = importlib.util.spec_from_file_location(
        "_root_conftest", _ROOT / "conftest.py"
    )
    conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conftest)

    # each slow test beside a test of its file, a parametrised case of it
    # and the same name in another file
    others = []
    for nodeid in SLOW_TESTS:
        path, name = nodeid.split("::", 1)
        others += [
            f"{path}::{name}_other",
            f"{nodeid}[0]",
            f"tests/test_other.py::{name}",
        ]
    items = [_Item(x) for x in others + list(SLOW_TESTS)]
    conftest.pytest_collection_modifyitems(items)

    assert sorted(x.nodeid for x in items if x.marks) == sorted(SLOW_TESTS)
    assert all(x.marks == ["slow"] for x in items if x.marks)


def test_slow_tests_name_functions_that_exist():
    # a renamed file or function would bring its test back into tier-1
    assert SLOW_TESTS
    for nodeid in SLOW_TESTS:
        path, name = nodeid.split("::")
        assert path.startswith("tests/test_") and (_ROOT / path).is_file()
        body = ast.parse((_ROOT / path).read_text()).body
        assert name in [x.name for x in body if isinstance(x, ast.FunctionDef)]
