"""The suite's longest-first file order (``tests/_suite_order.py``)."""

from _suite_order import SLOW_FILES, rank_of


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
