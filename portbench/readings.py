"""The readings the limits of ``correct`` are set from, in one process.

    python3 -m portbench.readings --workload <name> --seeds 1 2 3 \\
        --control-seeds 1 2 3 --seconds <s>

For each seed, one run of the cell with a window of ``--seconds`` (long
enough to finish and compare as many answers as a run does), printing one
JSON line: the program's numbers and, for the control seeds, the
numbers of the control (the reference in the configuration's
``control_precision``, put in the program's place on the same sample).
The process pays the build and the first set-up once.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .run import cache_dirs, loaded_forbidden
from .spec import load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cache_dirs()
    from .run import execute
    cell = load_cell(args.workload)
    control = cell.config["control_precision"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = execute(cell, seed, args.seconds, False, "cuda", t0,
                      control=control if seed in args.control_seeds
                      else None)
        run = res["_run"]
        line = {"workload": cell.name, "seed": seed,
                "correct": res["correct"], "program": res["_numbers"],
                "control": res.get("_control_numbers"),
                "setup_s": run.setup_s, "window_s": run.window_s,
                "slices": run.slices, "wall_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    found = loaded_forbidden()
    if found:
        print(f"loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
