"""The benchmark's files, found by name: JSON data, and Python files loaded
by path (their names may hold dots and dashes).

A model family's equations, parameter leaves and FLOP counts are the file
``bench/families/<family>.py`` that a configuration file names under
``family``; ``family(name)`` loads it once.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

_FAMILIES: dict = {}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str):
    """The module ``bench/families/<name>.py``."""
    if name not in _FAMILIES:
        _FAMILIES[name] = load_module(BENCH / "families" / f"{name}.py",
                                      "family." + name)
    return _FAMILIES[name]
