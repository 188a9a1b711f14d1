"""Nothing under h100bench/ imports jax or the JAX package, and the
reference imports nothing of the port: each import's top-level name is
compared whole (feos_tpu_torch is not feos_tpu)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "feos_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing", "torch"}


def test_whole_name_comparison():
    """The port's name begins with the JAX package's: a prefix test would
    wrongly refuse it."""
    assert "feos_tpu_torch".split(".")[0] != "feos_tpu"
    from h100bench.harness import FORBIDDEN
    assert "feos_tpu" in FORBIDDEN and "feos_tpu_torch" not in FORBIDDEN
