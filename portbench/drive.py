"""The general traffic generators: one per ``kind`` of traffic file.

``eval_closed``: one caller, back-to-back ``Evaluator.evaluate_records``
calls of ``batch`` slices each. Every batch holds ``batch / n_tasks``
slices of each task, drawn from the pool in an order the seed sets; the
window ends on a call boundary once ``seconds`` have passed.

``serve_open``: Poisson arrivals at a fixed ``rate`` into a
``RestorationService``, one slice a request, tasks uniform. Every seed
gets the same set of inter-arrival gaps (the exponential distribution's
quantiles at the midpoints of ``rate * seconds`` equal strata, scaled to
end at ``seconds``) in its own order, and its own slices, so the work and
the load are the same from seed to seed. A request is timed from its due
time to the resolution of its future; one that fails, or does not resolve
within ``drain_s`` of the window's close, counts as missing.

Each generator warms up every shape its traffic uses before the window,
and, traced, profiles a fixed count of calls or requests at the window's
start (the traffic file's ``trace_calls`` or ``trace_requests``). Stopping
the profiler takes seconds and holds the interpreter: a traced eval run
starts its ``seconds`` after it, and a traced serve run's later requests
are sent late, so its per-layer numbers come from the traced part.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import system
from .records import Pool
from .trace import Profile, Trace


@dataclasses.dataclass
class Run:
    """What a window did, as the metric readers and ``correct`` read it."""
    kind: str
    config: Dict
    traffic: Dict
    prior: Optional[ModuleType] = None     # the cell's ``priors/<prior>.py``
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    slices: int = 0            # restored in the window
    per_call: int = 0          # slices a call (eval)
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    stats: Optional[Dict] = None            # serve: stats() over the window
    traced_stats: Optional[Dict] = None     # ... over the traced part
    trace: Optional[Trace] = None
    traced_slices: int = 0
    traced_batches: int = 0
    late_ms_max: float = 0.0   # serve: how late the sender ran, at most
    # Answers: (pool index, image (H, W) or None, psnr dB, episode length).
    answers: List = dataclasses.field(default_factory=list)
    failed: int = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def eval_batches(pool: Pool, batch: int, seed: int):
    """Endless batches of pool indices: each ``batch / n_tasks`` slices of
    every task, drawn without repeats until the task's slices run out."""
    n_tasks = len(set(pool.tasks))
    if batch % n_tasks and batch != 1:
        raise ValueError(f"a batch of {batch} cannot hold every one of "
                         f"{n_tasks} tasks equally")
    rng = np.random.default_rng(seed)
    per = max(batch // n_tasks, 1)
    queues = [[] for _ in range(n_tasks)]
    task = 0
    while True:
        out = []
        tasks = range(n_tasks) if batch > 1 else [task]
        for k in tasks:
            while len(queues[k]) < per:
                queues[k].extend(k * pool.per_task
                                 + rng.permutation(pool.per_task))
            out.extend(queues[k][:per])
            del queues[k][:per]
        task = (task + 1) % n_tasks
        yield [int(i) for i in out]


def eval_closed(run: Run, models: system.Models, pool: Pool, seed: int,
                seconds: float, traced: bool, t_start: float) -> Run:
    tr = run.traffic
    batch = int(tr["batch"])
    ev = system.evaluator(run.config, models, spanned=traced)
    warm = eval_batches(pool, batch, seed ^ 0x5EED)
    for _ in range(int(tr["warmup_calls"])):
        ev.evaluate_records([pool.eval_record(i) for i in next(warm)])
    dev = models.device
    _sync(dev)
    batches = eval_batches(pool, batch, seed)
    outputs = []

    def call():
        idx = next(batches)
        recs = [pool.eval_record(i) for i in idx]
        t0 = time.perf_counter()
        m = ev.evaluate_records(recs)
        _sync(dev)
        t1 = time.perf_counter()
        run.latencies_ms.append(1e3 * (t1 - t0))
        outputs.append((idx, m["final_state"].x[:, 0], m["reward"],
                        m["episode_len"]))
        return t1

    t_first = time.perf_counter()
    run.setup_s = t_first - t_start
    t_window = t_first
    prof = Profile() if traced else None
    if prof is not None:
        prof.start()
        for _ in range(int(tr["trace_calls"])):
            call()
        prof.stop()   # takes seconds: the rest of the window starts after
        run.traced_slices = int(tr["trace_calls"]) * batch
        t_window = time.perf_counter()
    while True:
        t1 = call()
        if t1 - t_window >= seconds:
            break
    run.window_s = t1 - t_window
    if prof is not None:
        run.trace = prof.read()
    run.per_call = batch
    run.slices = run.attempted = batch * len(outputs)
    for idx, x, reward, ep in outputs:
        run.failed += int((~np.isfinite(np.asarray(reward))).sum())
        run.answers.extend(zip(idx, x, np.asarray(reward, np.float64),
                               np.asarray(ep)))
    return run


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds]: the stratified exponential gaps of
    ``rate * seconds`` requests in the seed's order, scaled to end at
    ``seconds``."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng(seed).permutation(gaps)
    due = np.cumsum(gaps)
    return due * (seconds / due[-1])


def serve_open(run: Run, models: system.Models, pool: Pool, seed: int,
               seconds: float, traced: bool, t_start: float,
               rate: Optional[float] = None) -> Run:
    tr = run.traffic
    rate = float(tr["rate"] if rate is None else rate)
    params = dict(tr["service"])
    svc = system.service(run.config, models, params, spanned=traced)
    reqs = [system.request(rec, pool.rtg, task)
            for rec, task in zip(pool.records, pool.tasks)]
    rng = np.random.default_rng(seed)
    due = arrivals(rate, seconds, seed)
    n_tasks = len(set(pool.tasks))
    pick = (rng.integers(n_tasks, size=len(due)) * pool.per_task
            + rng.integers(pool.per_task, size=len(due)))
    futures: List = []
    resolved: List[Optional[float]] = [None] * len(due)
    n_traced = min(int(tr["trace_requests"]), len(due)) if traced else 0
    traced_done = threading.Event()
    left = [n_traced]
    lock = threading.Lock()

    def on_done(i):
        def cb(_):
            resolved[i] = time.perf_counter()
            if i < n_traced:
                with lock:
                    left[0] -= 1
                    if left[0] == 0:
                        traced_done.set()
        return cb

    def send(t_first):
        """Submit each request at its due time (the sender's own
        thread, so that nothing the main thread does delays it)."""
        for i, d in enumerate(due):
            wait = t_first + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            run.late_ms_max = max(run.late_ms_max,
                                  1e3 * (time.perf_counter() - t_first - d))
            fut = svc.submit(reqs[pick[i]])
            fut.add_done_callback(on_done(i))
            futures.append(fut)

    try:
        warm_rng = np.random.default_rng(seed ^ 0x5EED)
        for _ in range(int(tr["warmup_batches"])):
            warm = warm_rng.integers(len(reqs), size=params["batch_size"])
            for f in [svc.submit(reqs[i]) for i in warm]:
                f.result(timeout=600)
        prof = Profile() if traced else None
        before = svc.stats()
        if prof is not None:
            prof.start()
        t_first = time.perf_counter()
        run.setup_s = t_first - t_start
        sender = threading.Thread(target=send, args=(t_first,), daemon=True)
        sender.start()
        if prof is not None:
            traced_done.wait(seconds + float(tr["drain_s"]))
            traced_stats = svc.stats()
            prof.stop()
        sender.join()
        run.window_s = time.perf_counter() - t_first
        close = time.perf_counter()
        for f in futures:
            try:
                f.result(timeout=max(0.0, close + tr["drain_s"]
                                     - time.perf_counter()))
            except Exception:   # noqa: BLE001 - counted as missing
                pass
        after = svc.stats()
    finally:
        svc.close(timeout=600)
    def delta(end):
        out = {k: end[k] - before[k] for k in
               ("submitted", "completed", "failed", "rejected", "batches",
                "padded_slots")}
        return dict(out, batch_size=params["batch_size"])

    run.stats = delta(after)
    if prof is not None:
        run.trace = prof.read()
        run.traced_stats = delta(traced_stats)
        run.traced_batches = run.traced_stats["batches"]
    run.attempted = len(due)
    for i, f in enumerate(futures):
        res = None
        if f.done() and not f.cancelled() and f.exception() is None:
            res = f.result()
        if res is None or resolved[i] is None:
            run.failed += 1
            run.latencies_ms.append(float("inf"))
            continue
        run.latencies_ms.append(1e3 * (resolved[i] - t_first - due[i]))
        run.answers.append((int(pick[i]), res.image, res.psnr_db,
                            res.episode_len))
    run.failed += len(due) - len(futures)
    run.slices = len(run.answers)
    # Requests due and not yet resolved at the window's middle and close.
    t_res = np.array([np.inf if r is None else r - t_first
                      for r in resolved])
    for key, at in (("backlog_mid", seconds / 2), ("backlog_end", seconds)):
        run.stats[key] = int(((due <= at) & (t_res > at)).sum())
    return run


GENERATORS: Dict[str, Callable] = {"eval_closed": eval_closed,
                                "serve_open": serve_open}
