"""The traffic generators: arrivals and batches from the seed, and open-loop
latency timed from each request's due time."""
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import drive
from portbench.records import Pool


def test_arrivals_are_fixed_per_seed_and_one_set_of_gaps_for_all():
    a, b = drive.arrivals(24.0, 25.0, 7), drive.arrivals(24.0, 25.0, 7)
    np.testing.assert_array_equal(a, b)
    c = drive.arrivals(24.0, 25.0, 2 ** 31 + 5)
    assert not np.array_equal(a, c)
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0.0)),
                               np.sort(np.diff(c, prepend=0.0)))
    assert len(a) == 600 and a[-1] == pytest.approx(25.0)
    assert np.all(np.diff(a) > 0)


def _pool(n_tasks=9, per_task=14):
    return Pool(records=[None] * (n_tasks * per_task),
                tasks=[k for k in range(n_tasks) for _ in range(per_task)],
                rtg=0.5, per_task=per_task)


def test_every_batch_holds_each_task_equally_in_the_seeds_order():
    pool = _pool()
    gen = drive.eval_batches(pool, 63, 11)
    batches = [next(gen) for _ in range(4)]
    for idx in batches:
        tasks = [pool.tasks[i] for i in idx]
        assert sorted(tasks) == sorted(list(range(9)) * 7)
    # Two batches use each task's 14 slices once.
    assert sorted(batches[0] + batches[1]) == list(range(126))
    again = drive.eval_batches(pool, 63, 11)
    assert [next(again) for _ in range(4)] == batches
    other = drive.eval_batches(pool, 63, 12)
    assert next(other) != batches[0]


def test_one_slice_calls_take_the_tasks_in_turn():
    pool = _pool()
    gen = drive.eval_batches(pool, 1, 3)
    tasks = [pool.tasks[next(gen)[0]] for _ in range(18)]
    assert tasks == list(range(9)) * 2
    with pytest.raises(ValueError):
        next(drive.eval_batches(pool, 10, 3))


class SlowService:
    """Resolves every request ``delay`` seconds after it was submitted."""

    def __init__(self, delay):
        self.delay = delay
        self.n = 0
        self.timers = []

    def submit(self, req):
        fut = Future()
        t = threading.Timer(self.delay, fut.set_result,
                            (SimpleNamespace(image=np.zeros((2, 2)),
                                             psnr_db=1.0, episode_len=30),))
        t.start()
        self.timers.append(t)
        self.n += 1
        return fut

    def stats(self):
        return {"submitted": self.n, "completed": self.n, "failed": 0,
                "rejected": 0, "batches": self.n, "padded_slots": 0}

    def close(self, timeout=None):
        for t in self.timers:
            t.join(timeout)


def test_open_loop_latency_runs_from_the_due_time(monkeypatch):
    svc = SlowService(0.05)
    monkeypatch.setattr(drive.system, "service", lambda *a, **k: svc)
    monkeypatch.setattr(drive.system, "request", lambda *a: a)
    pool = _pool(n_tasks=1, per_task=2)
    pool.records = [{}, {}]
    run = drive.Run(kind="serve_open", config={}, traffic={
        "rate": 40.0, "service": {"batch_size": 2}, "warmup_batches": 0,
        "trace_requests": 0, "drain_s": 5})
    # The sender sleeps through the first 0.2 s: every request due then
    # is sent late, and its latency holds the wait.
    real_sleep = time.sleep
    slept = []

    def sleep(s):
        if not slept:
            slept.append(s)
            real_sleep(0.2)
        real_sleep(s)
    monkeypatch.setattr(drive.time, "sleep", sleep)
    drive.serve_open(run, None, pool, seed=5, seconds=1.0, traced=False,
                     t_start=time.perf_counter())
    due = drive.arrivals(40.0, 1.0, 5)
    lat = np.asarray(run.latencies_ms)
    assert run.attempted == len(due) == 40 and run.failed == 0
    assert np.all(lat >= 50.0 - 1.0)
    early = due < 0.2
    assert np.all(lat[early] >= 1e3 * (0.2 - due[early]))
    assert run.late_ms_max >= 150.0
