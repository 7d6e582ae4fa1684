"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric is a file of its own under this package:

  * ``configs/<config>.json``: the model's sizes, dtype and problem, and
    under ``prior`` the name of its plug-in prior;
  * ``priors/<prior>.py``: the prior's weights, its build in the port, its
    plain reference and its counts (:data:`PRIOR_FUNCTIONS`);
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
import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent

# What a prior module defines:
#   state_dict(cfg, gen, device): random weights in the published
#       checkpoint's key layout, drawn from ``gen`` after the policy's;
#   system(cfg, sd, device): the port's denoiser, a callable
#       (x (B, 1, H, W), sigma (B,)) -> clamped (B, 1, H, W); the only
#       function that imports the port, and it does so inside its body;
#   reference(sd, img, sigma, precision): the same in plain torch, its
#       products rounded by :func:`.reference.round_operand`;
#   flops(cfg): FLOPs of one call on one slice;
#   bytes(cfg, batch): bytes one call at ``batch`` must move.
PRIOR_FUNCTIONS = ("state_dict", "system", "reference", "flops", "bytes")


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
    prior: ModuleType
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


@functools.lru_cache(maxsize=None)
def load_prior(name: str, package: Path = PACKAGE) -> ModuleType:
    """``priors/<name>.py``, loaded by its path."""
    path = package / "priors" / f"{name}.py"
    if not path.exists():
        have = sorted(p.stem for p in (package / "priors").glob("*.py"))
        raise KeyError(f"no prior {name!r} at {path}; have {have}")
    spec = importlib.util.spec_from_file_location(f"portbench_prior_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in PRIOR_FUNCTIONS
               if not callable(getattr(module, f, None))]
    if missing:
        raise AttributeError(f"prior {name!r} at {path} lacks {missing}")
    return module


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
    config = _json(package / "configs" / f"{w['config']}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        prior=load_prior(config["prior"], package),
        traffic=_json(package / "traffic" / f"{w['traffic']}.json"),
        limits=_json(package / "limits" / f"{name}.json"),
        end_to_end=[Metric(m["name"], m["unit"],
                           load_reader(m["name"], package)) for m in e2e],
        per_layer=[Metric(m["name"], m["unit"],
                          load_reader(m["name"], package)) for m in layer])
