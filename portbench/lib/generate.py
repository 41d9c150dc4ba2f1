"""The benchmark's one traffic generator: it reads a traffic mix's
parameters (``portbench/traffic/<name>.json``) and makes the data of a
run from ``--seed``.  The data compressed is the traffic of this system.
The file's ``"generator"`` key names the recipe, a module of its own
(``portbench/recipes/<generator>.py``, found by name), and the file holds
every number the recipe uses.  A recipe's ``make(params, nbytes, seed)``
makes exactly ``nbytes``, the same bytes for the same seed; the mix's
``layout_seed`` fixes what sets the codec's work, so that every seed
puts the same work on it.

:func:`pool` cuts the bytes into a run's waves, each block in the same
lane for every seed; the run's ``--seed`` also draws the blocks that
are compared with the reference (``lib/check.py``).
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

RECIPES = pathlib.Path(__file__).resolve().parent.parent / "recipes"


def recipe(name: str, where: pathlib.Path = RECIPES):
    """The ``make`` function of ``<where>/<name>.py`` (``where``: a
    checkout's ``portbench/recipes``)."""
    path = pathlib.Path(where) / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not path.is_file():
        raise ValueError(f"no traffic recipe {name!r}")
    spec = importlib.util.spec_from_file_location(
        "portbench_recipe_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def generate(traffic: dict, nbytes: int, seed: int,
             where: pathlib.Path = RECIPES) -> bytes:
    """``nbytes`` of the traffic mix ``traffic`` (its parsed file) for
    ``seed``, by its recipe in ``where``."""
    make = recipe(traffic["generator"], where)
    if seed < 0:
        raise ValueError(f"seed {seed} is negative")
    return make(traffic, nbytes, seed)


def pool(traffic: dict, nwaves: int, lanes: int, block: int, seed: int,
         where: pathlib.Path = RECIPES) -> list:
    """A run's waves: ``nwaves`` of ``lanes`` blocks of ``block`` bytes,
    made from ``seed``.  A wave takes its slowest lane's time, and that
    depends on the lane's block and on its place (up to 3 % a 1 MiB
    wave), so a block's place in the data is its lane for every seed."""
    data = generate(traffic, nwaves * lanes * block, seed, where)
    size = lanes * block
    return [[data[w * size + i * block : w * size + (i + 1) * block]
             for i in range(lanes)] for w in range(nwaves)]
