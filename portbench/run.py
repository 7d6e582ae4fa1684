"""One run of one cell: set-up, the measured window, the metrics, and the
check of the window's answers against the reference.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

prints the result as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, also printed as the last lines of standard error. The
run needs as many CUDA cards as the cell asks for: without them it exits
2 and prints no result. It exits 3, with no result, when JAX or the JAX
package was loaded in the process.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from . import correct as correct_mod
from .drive import GENERATORS, Run
from .records import make_pool
from .spec import ROOT, Cell, load_cell
from .system import Models
from .trace import breakdown
from .weights import make_weights

FORBIDDEN = ("jax", "jaxlib", "flax", "dt4image_restoration_tpu")


def loaded_forbidden() -> List[str]:
    """Forbidden top-level packages in ``sys.modules``, by whole name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, rate: Optional[float] = None,
            control: Optional[str] = None) -> Dict:
    """Run ``cell`` once and return its result. ``rate`` replaces an open
    loop's rate (the knee's sweep); with ``control``, the result also holds
    the numbers of the reference in that precision put in the program's
    place, on the same sample, under ``_control_numbers``."""
    cfg, tr = cell.config, cell.traffic
    seed &= (1 << 63) - 1
    dev = torch.device(device)
    dt_sd, unet_sd = make_weights(cfg, seed, dev)
    pool = make_pool(cfg, int(tr["pool_per_task"]), seed)
    models = Models(cfg, dt_sd, unet_sd, dev)
    run = Run(kind=tr["kind"], config=cfg, traffic=tr)
    extra = {"rate": rate} if rate is not None else {}
    GENERATORS[tr["kind"]](run, models, pool, seed, seconds, trace, t_start,
                        **extra)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    cuda = dev.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)
            if cuda else 0}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s

    # The program's state goes before the reference runs; only the
    # sampled answers stay, on the host.
    idx = correct_mod.sample(len(run.answers), int(tr["check_sample"]), seed)
    ids, images, psnrs, lens = correct_mod.program_answers(run.answers, idx)
    run.answers = []
    del models
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    block = int(tr["check_block"])
    ref = correct_mod.reference_answers(cfg, dt_sd, unet_sd, pool, ids, dev,
                                        block)
    numbers = correct_mod.compare(images, psnrs, lens, ref)
    ok, checks = correct_mod.judge(numbers, cell.limits)
    checks = {"missing_answers": {"value": run.failed, "limit": 0},
              "compared_answers": {"value": len(ids),
                                   "limit": min(int(tr["check_sample"]),
                                                run.attempted)},
              **checks}
    result = {"correct": bool(ok and run.failed == 0
                              and len(ids) == checks["compared_answers"]
                              ["limit"] and len(ids) > 0),
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": info}
    if trace:
        result["breakdown"] = breakdown(run.trace)
    if control is not None:
        low = correct_mod.reference_answers(cfg, dt_sd, unet_sd, pool, ids,
                                            dev, block, precision=control)
        result["_control_numbers"] = correct_mod.compare(*low, ref)
    result["checks"] = checks
    result["_run"] = run
    result["_numbers"] = numbers
    return result


def emit(result: Dict) -> None:
    """Print the checks on standard error and the result line last on
    standard output."""
    result = {k: v for k, v in result.items() if not k.startswith("_")}
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    for c in result["checks"].values():
        c["value"] = _finite(c["value"])
    for m in result["metrics"].values():
        m["value"] = _finite(m["value"])
    print(json.dumps(result, allow_nan=False), flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m portbench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def cache_dirs(root=ROOT) -> None:
    """Kernel caches of fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(root / "build" / "portbench" / sub))


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = build_parser().parse_args(argv)
    cache_dirs()
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t_start)
    run = result["_run"]
    print(f"portbench: {args.workload} seed {args.seed}: {power_limit()}; "
          f"setup {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"{run.slices} slices; serve stats {run.stats}; sender late at "
          f"most {run.late_ms_max:.1f} ms", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process loaded {found}; no result",
              file=sys.stderr)
        return 3
    emit(result)
    return 0
