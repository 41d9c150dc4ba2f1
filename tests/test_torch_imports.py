"""The port stands alone: no module of ``x3tpu_torch`` and not
``chip_smoke.py`` imports the JAX package (``x3tpu``) or ``jax``, at any
depth of the module (a function-level import counts too).  The port's own
``x3tpu_torch`` imports are allowed."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(ROOT.glob("x3tpu_torch/**/*.py")) + [ROOT / "chip_smoke.py"]
BANNED = {"x3tpu", "jax", "jaxlib"}


def banned_imports(source: str):
    """(line, module) of every import of a banned top-level package."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in BANNED]
    return found


def test_guard_sees_banned_imports():
    code = ("import x3tpu\nimport jax.numpy as jnp\n"
            "from x3tpu.parallel import blocks\nimport x3tpu_torch\n"
            "from x3tpu_torch import codec\n"
            "def f():\n    from x3tpu import host\n")
    assert banned_imports(code) == [(1, "x3tpu"), (2, "jax.numpy"),
                                    (3, "x3tpu.parallel"), (7, "x3tpu")]


def test_guard_covers_every_module():
    """The port's entry points, host trainer and utilities are among the
    files the guard reads."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("__init__", "__main__", "cli", "host", "codec",
                "parallel/runtime", "parallel/blocks", "parallel/mesh",
                "parallel/distributed", "vm/driver",
                "utils/timing", "utils/profiling", "utils/stats"):
        assert f"x3tpu_torch/{mod}.py" in names, mod


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_port_imports_no_jax_package(path):
    assert banned_imports(path.read_text()) == []
