"""The cells of ``BENCHMARK.json`` and the files each is made of, found by name.

A cell names a configuration (``configs/<config>.json``, the file that
``BENCHMARK.json`` gives it) and a traffic mix (``traffic/<traffic>.json``).
The traffic file's ``kind`` names the module that drives the system under
test (``kinds/<kind>.py``), and the configuration's ``reference`` names its
plain reference (``references/<reference>.py``); each per-layer metric has
its reader in ``metrics/<metric>.py``. A new cell, mix, kind, reference or
metric is a new file and a new entry, never an edit of one of these.

This module imports neither torch nor the program, so that ``run.py`` can
set a configuration's environment before either is loaded.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
# Top-level module names that must not be loaded by a run: JAX and the JAX
# package beside the port, compared whole on the part before the first dot.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dither_pie_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (it then prints none)."""


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[str]
    per_layer: List[str]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: Dict[str, Any], name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration file, its traffic file
    (``traffic/<traffic>.json``) and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m["name"] for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m["name"] for m in bench["per_layer"] if _applies(m, name)])


def environment(config: Dict[str, Any]) -> Dict[str, str]:
    """The environment variables the configuration runs the program under
    (its ``env`` map; none by default)."""
    env = config.get("env", {})
    if not all(isinstance(k, str) and isinstance(v, str) for k, v in env.items()):
        raise RunError(f"a configuration's env maps names to strings: {env!r}")
    return dict(env)


def load_module(folder: str, name: str) -> ModuleType:
    """The module ``<folder>/<name>.py`` of the benchmark, loaded from its
    file (a name may hold ``-`` and ``.``)."""
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no {folder} module {name!r} at {path}")
    key = "portbench_{}_{}".format(folder, name.replace("-", "__dash__").replace(".", "__dot__"))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})
