"""Find the highest rate an open-loop cell sustains, once, by a sweep.

    python3 -m portbench.sweep --workload <name> --seconds <s> \\
        --rates 16 20 24 ...

One run a rate (seeds ``--seed``, ``--seed`` + 1, ...), each printing a
JSON line: requests due, completed and failed, the backlog (due and not
yet resolved) at the window's middle and at its close, the latency
median and 95th percentile, how late the sender ran, and ``sustained``:
every request completed, none failed, and the backlog at the close no
larger than at the middle plus one batch.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .run import cache_dirs
from .spec import load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    cache_dirs()
    from .run import execute
    cell = load_cell(args.workload)
    batch = cell.traffic["service"]["batch_size"]
    for i, rate in enumerate(args.rates):
        t0 = time.perf_counter()
        res = execute(cell, args.seed + i, args.seconds, False, "cuda",
                      t0, rate=rate)
        run = res["_run"]
        lat = np.asarray(run.latencies_ms)
        s = run.stats
        line = {"rate": rate, "due": run.attempted,
                "completed": s["completed"], "failed": run.failed,
                "backlog_mid": s["backlog_mid"],
                "backlog_end": s["backlog_end"],
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "late_ms_max": run.late_ms_max, "batches": s["batches"],
                "padded_slots": s["padded_slots"],
                "correct": res["correct"],
                "sustained": bool(run.failed == 0
                                  and s["completed"] == run.attempted
                                  and s["backlog_end"]
                                  <= s["backlog_mid"] + batch)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
