"""Resolving a cell by name: ``BENCHMARK.json`` at the checkout's root
names the cell's configuration and traffic, and each is a file of its
own that the harness finds by that name:

- ``portbench/configs/<config>.json`` (the ``file`` of its entry): the
  sizes, the optimizer, the precision, and ``system``, the module
  ``portbench/systems/<system>.py`` that builds the program's step;
- ``portbench/reference/<config>.py``: its plain reference;
- ``portbench/traffic/<traffic>.json``: the parameters of its inputs;
- ``portbench/limits/<cell>.json``: the limits of the numbers the
  comparison with the reference checks;
- ``portbench/metrics/<metric>.py``: the reader of each per-layer metric.

A new configuration, traffic mix, cell or metric is new files and new
entries; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]   # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]

    @property
    def system(self):
        return importlib.import_module(
            f"portbench.systems.{self.config['system']}")

    @property
    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.config['name']}")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(root / entry["file"])
    if config["name"] != w["config"]:
        raise ValueError(f"{entry['file']} names {config['name']!r}, not "
                         f"{w['config']!r}")
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _json(BENCH / "limits" / f"{name}.json")["limits"]
    return Cell(name, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The ``read(run)`` function of ``portbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
