"""The import guard: nothing under ``portbench/`` imports JAX or the JAX
package (top-level module names compared whole, so ``x3tpu_torch``
passes), and the reference imports nothing of the program either."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "x3tpu"}
PROGRAM = "x3tpu_torch"


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    names.add(arg.value.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path)


def test_guard_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import x3tpu_torch\nfrom x3tpu.spec import encode\n"
                 "import jaxlib.xla_client\n"
                 "importlib.import_module('jax.numpy')\n")
    assert top_level_imports(f) == {"x3tpu_torch", "x3tpu", "jaxlib", "jax"}
