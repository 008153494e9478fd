"""Finds what a cell is made of by the names ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``,
``generators/<kind>.py`` and the table of peaks, ``peaks.json``."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
_modules: dict = {}


def checked(name: str) -> str:
    """``name`` if it is a valid benchmark name, else ValueError."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(CHECKOUT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{checked(name)}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{checked(name)}.json")


def peaks(kind: str):
    """The data-sheet peaks of the card named ``kind``, or None."""
    return _json(HERE / "peaks.json").get(kind)


def _load(folder: str, name: str):
    key = (folder, checked(name))
    if key not in _modules:
        path = HERE / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}",
            path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def metric(name: str):
    """The reader of metric ``name``: a module with ``read(reading)``."""
    return _load("metrics", name)


def generator(kind: str):
    """The scene generator ``kind``: a module with ``build(params, rng)``."""
    return _load("generators", kind)


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The entries of ``section`` ('end_to_end' or 'per_layer') that the
    cell reports: those without a ``workloads`` list and those whose list
    names it."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]
