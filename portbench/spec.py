"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric is a file of its own under this package:

  * ``configs/<config>.json``: the model's sizes, dtype and problem;
  * ``traffic/<traffic>.json``: the mix's parameters, read by the one
    general generator of its ``kind`` (:mod:`.drive`);
  * ``limits/<workload>.json``: the limit of each number ``correct``
    compares, with the readings it was set from;
  * ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.

So a cell or a metric is added by adding files and entries, and no file
that is there has to change.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_reader(name: str, package: Path = PACKAGE) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = package / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reported(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or, without a
    list, it reports the end-to-end metric the metric moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in e2e_names


def load_cell(name: str, root: Path = ROOT, package: Path = PACKAGE,
              bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(package / "configs" / f"{w['config']}.json"),
        traffic=_json(package / "traffic" / f"{w['traffic']}.json"),
        limits=_json(package / "limits" / f"{name}.json"),
        end_to_end=[Metric(m["name"], m["unit"],
                           load_reader(m["name"], package)) for m in e2e],
        per_layer=[Metric(m["name"], m["unit"],
                          load_reader(m["name"], package)) for m in layer])
