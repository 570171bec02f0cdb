"""Nothing under benchmark/ imports JAX, its libraries or the JAX package;
``reference/`` imports nothing of the program either.  Top-level module
names are compared as whole words: the program's name begins with the
JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
       "multimodal_brain_pattern_identification_xai_tpu"}
PORT = "multimodal_brain_pattern_identification_xai_tpu_torch"
FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def _top_levels(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (_top_levels(path) & JAX)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    names = _top_levels(path)
    assert PORT not in names and "benchmark" not in names
    assert names <= {"__future__", "concurrent", "contextlib", "functools",
                     "importlib", "math", "os", "re", "types", "typing",
                     "numpy", "scipy", "torch"}


def test_whole_word_comparison():
    src = f"import {PORT}.entry\nfrom {PORT} import xai\n"
    tree = Path(__file__).parent / "_probe.py"
    tree.write_text(src)
    try:
        assert _top_levels(tree) == {PORT} and not (_top_levels(tree) & JAX)
    finally:
        tree.unlink()
