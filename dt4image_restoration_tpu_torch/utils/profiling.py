"""Tracing and step timing (the port's copy of the JAX package's
``utils/profiling.py``, on ``torch.profiler``).

Usage:
    with trace_if_enabled():          # honours DT4IR_TRACE_DIR
        with annotate("train_step"):
            run_workload()

A span costs a flag test and nothing more while no profiler runs, so the
spans stay in the hot loops. Both tree searches (``inference/mcts.py``,
``inference/mcts_device.py``) annotate each round as
``SEARCH_ROUND.format(i)``, so that one round of either backend can be read
from a trace with :func:`region_breakdown`. The evaluation loop, the ADMM
step, the priors (U-Net, DRUNet) and the service annotate their work under
the ``dt4ir.`` names below; the evaluator's spans nest under
``SERVE_LAUNCH`` when the service runs them.

    timer = StepTimer(device)
    for batch in ...:
        with timer:
            step(...)
    print(timer.summary())
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator, List, Mapping, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_ENV_VAR = "DT4IR_TRACE_DIR"
TRACE_FILE = "trace.json"
# Chrome-trace categories of the work a CUDA device runs.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The span of round i of a tree search.
SEARCH_ROUND = "search round {}"
# Evaluation (inference/evaluator.py): a call's stacking and copy to the
# device, one shard's rollout, one iteration of the greedy loop, and each
# device-to-host read that decides the loop's control flow.
EVAL_PREPARE = "dt4ir.eval.prepare"
EVAL_ROLLOUT = "dt4ir.eval.rollout"
EVAL_STEP = "dt4ir.eval.step"
EVAL_SYNC = "dt4ir.eval.sync"
# One ADMM iteration and its masked merge; one U-Net forward; one DRUNet
# forward; one policy step (buffer writes, state encoder, the two DT
# forwards, masked merges).
ENV_ADMM = "dt4ir.env.admm"
UNET = "dt4ir.unet"
DRUNET = "dt4ir.drunet"
POLICY_STEP = "dt4ir.policy.step"
# Inside a policy step run through a graph cache (the evaluator's on
# CUDA): the replay of its CUDA graph (or, without CUDA, the same static
# step run uncaptured).
POLICY_GRAPH = "dt4ir.policy.graph"
# Inside a prior's forward run through a graph cache (the evaluator's on
# CUDA, ``models/prior_graphs.py``): the replay of its CUDA graph.
PRIOR_GRAPH = "dt4ir.prior.graph"
# The service's worker: the wait for a first request, the fill window after
# it, the wait for an in-flight permit, the launch of a batch; its resolver:
# the wait for a batch's copies and its results, and settling the futures.
SERVE_WAIT = "dt4ir.serve.wait"
SERVE_FILL = "dt4ir.serve.fill"
SERVE_PERMIT = "dt4ir.serve.permit"
SERVE_LAUNCH = "dt4ir.serve.launch"
SERVE_RESOLVE = "dt4ir.serve.resolve"
SERVE_SETTLE = "dt4ir.serve.settle"
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace_if_enabled(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a GPU is present) when a trace directory is given or
    DT4IR_TRACE_DIR is set, and write its Chrome trace to
    ``<trace_dir>/trace.json``; a no-op otherwise. Every thread of the
    process is traced, those started before the block too (a service's
    worker and resolver), where this PyTorch can; else the calling
    thread and those it starts inside the block."""
    trace_dir = trace_dir or os.environ.get(TRACE_ENV_VAR)
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                **_all_threads()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


def _all_threads() -> Dict:
    """``torch.profiler.profile``'s keywords that trace every thread of the
    process; none where this PyTorch lacks the setting."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


def annotate(name: str) -> contextlib.AbstractContextManager:
    """A named span (``record_function``) while a profiler runs; otherwise
    one shared no-op, so that a span off costs a flag test."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def region_breakdown(events: Iterable[Mapping], region: str, top: int = 8
                     ) -> Dict:
    """Device time inside one annotated region of a Chrome trace
    (``json.load(open(trace.json))["traceEvents"]``).

    The region is the host span of ``annotate(region)``; the caller
    synchronises the device inside it, so that the device work of the
    region ends inside the span. Returns the span's wall ms, the device's
    busy ms (the union of its kernel, copy and set intervals in the span),
    the idle share of the span, and the ``top`` device ops by summed time
    with their counts."""
    events = list(events)
    spans = [e for e in events if e.get("name") == region
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host spans named {region!r} in the "
                         "trace; want one")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    intervals, ops = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES or e.get("ph") != "X":
            continue
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        intervals.append((a, b))
        ms, n = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (ms + (b - a) / 1e3, n + 1)
    busy, end = 0.0, t0
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = t1 - t0
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall / 1e3, "device_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall if wall > 0 else None,
            "device_ops": len(intervals),
            "top_ops": [{"name": name[:120], "ms": ms, "count": n}
                        for name, (ms, n) in ranked]}


class StepTimer:
    """Wall-clock step timer with a percentile summary.

    On a CUDA device it synchronises the device when a step ends, so a
    step's time includes the device work the step queued, not only the
    host's time to queue it."""

    def __init__(self, device=None) -> None:
        self.times: List[float] = []
        self._t0 = 0.0
        self._sync = device is not None and torch.device(device).type == \
            "cuda"
        self._device = device

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._sync:
            torch.cuda.synchronize(self._device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }
