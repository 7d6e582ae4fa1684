"""Reading a ``torch.profiler`` Chrome trace: device busy time, kernels
under a host span, idle gaps and the largest device ops.

The interval arithmetic is a copy of the port's
``utils/profiling.py:region_breakdown`` (device work is the union of the
kernel, copy and set intervals), kept here so that the yardstick cannot
move with the program. A kernel belongs to a host span when the runtime
call that launched it (the event with the same ``correlation``) lies in
the span, on the span's thread.
"""
from __future__ import annotations

import bisect
import dataclasses
import gzip
import heapq
import json
import os
import tempfile
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
WINDOW_SPAN = "portbench.window"
# Around each call of the prior, whichever the configuration names; the
# name stays as the first prior, the U-Net, gave it.
UNET_SPAN = "portbench.unet"
TOP = 10


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals: Iterable[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [t0, t1] that no interval covers."""
    out, end = [], t0
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, t1)))
        end = max(end, b)
        if end >= t1:
            break
    if end < t1:
        out.append((end, t1))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    """The events of one traced window, in seconds on the trace's clock.

    ``window``: (start, end) of the :data:`WINDOW_SPAN` host span;
    ``device``: (start, end, name) of each device op overlapping it;
    ``spans``: (start, end, thread) of each :data:`UNET_SPAN` span in it;
    ``unet_device``: (start, end) of each device op launched under one;
    ``host``: (start, end, name) of the host ops in it."""
    window: Tuple[float, float]
    device: List[Tuple[float, float, str]]
    spans: List[Tuple[float, float, object]]
    unet_device: List[Tuple[float, float]]
    host: List[Tuple[float, float, str]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which a device op ran."""
        t0, t1 = self.window
        return union_s((max(a, t0), min(b, t1)) for a, b, _ in self.device
                       if min(b, t1) > max(a, t0))

    def unet_device_s(self) -> float:
        """Device seconds of the ops launched under the U-Net spans."""
        return union_s(self.unet_device)

    def top_ops(self, top: int = TOP) -> List[List]:
        """The device ops that took most time, summed by name."""
        t0, t1 = self.window
        ops: Dict[str, float] = {}
        for a, b, name in self.device:
            d = min(b, t1) - max(a, t0)
            if d > 0:
                ops[name] = ops.get(name, 0.0) + d
        return [[name[:120], s] for name, s in
                sorted(ops.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = TOP) -> List[List]:
        """The device's idle time in the window, summed by the innermost
        host op running at each gap's middle ("no host op" when none)."""
        t0, t1 = self.window
        host = sorted(self.host)
        by: Dict[str, float] = {}
        active: List[Tuple[float, float, str]] = []   # a heap by end
        nxt = 0
        for a, b in gaps([(x, y) for x, y, _ in self.device], t0, t1):
            mid = 0.5 * (a + b)
            while nxt < len(host) and host[nxt][0] <= mid:
                x, y, name = host[nxt]
                heapq.heappush(active, (y, x, name))
                nxt += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            name = min(((y - x, n) for y, x, n in active),
                       default=(0.0, "no host op"))[1]
            by[name] = by.get(name, 0.0) + (b - a)
        return [[name[:120], s] for name, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _x(e: Mapping) -> Tuple[float, float]:
    t = float(e["ts"]) * 1e-6
    return t, t + float(e.get("dur", 0.0)) * 1e-6


def read_events(events: List[Mapping]) -> Trace:
    """The :class:`Trace` of a Chrome trace's ``traceEvents``. Raises
    ``ValueError`` unless it holds exactly one :data:`WINDOW_SPAN`."""
    complete = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in complete if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} host spans named {WINDOW_SPAN!r} "
                         "in the trace; want one")
    t0, t1 = _x(windows[0])
    spans = [(*_x(e), (e.get("pid"), e.get("tid"))) for e in complete
             if e.get("name") == UNET_SPAN
             and e.get("cat") == "user_annotation"
             and _x(e)[0] >= t0 and _x(e)[1] <= t1]
    launches = {}
    host = []
    for e in complete:
        cat = e.get("cat")
        if cat not in HOST_CATEGORIES:
            continue
        a, b = _x(e)
        if b < t0 or a > t1:
            continue
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (a, (e.get("pid"), e.get("tid")))
        if e.get("name") != WINDOW_SPAN:
            host.append((a, b, e.get("name", "")))
    by_thread: Dict[object, List[Tuple[float, float]]] = {}
    for s0, s1, th in sorted(spans):
        by_thread.setdefault(th, []).append((s0, s1))
    starts = {th: [s0 for s0, _ in v] for th, v in by_thread.items()}

    def under_span(t: float, th) -> bool:
        i = bisect.bisect_right(starts.get(th, []), t) - 1
        return i >= 0 and by_thread[th][i][1] >= t

    device, unet = [], []
    for e in complete:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a, b = _x(e)
        if b <= t0 or a >= t1:
            continue
        device.append((a, b, e.get("name", "")))
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None and under_span(*launch):
            unet.append((a, b))
    return Trace((t0, t1), device, spans, unet, host)


class Profile:
    """A ``torch.profiler`` session (host and, on a card, device activity)
    around a :data:`WINDOW_SPAN` span opened and closed on the calling
    thread. :meth:`read` exports the Chrome trace through a temporary file
    that is deleted at once; call it after the measured window, since the
    export takes seconds."""

    def __init__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._span = None

    def start(self) -> None:
        self._prof.start()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> None:
        self._span.__exit__(None, None, None)
        self._prof.stop()

    def read(self) -> Trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json.gz")
            self._prof.export_chrome_trace(path)
            with gzip.open(path, "rt") as f:
                events = json.load(f)["traceEvents"]
        return read_events(events)


def unet_span() -> torch.profiler.record_function:
    """The span of one prior call."""
    return torch.profiler.record_function(UNET_SPAN)


def breakdown(trace: Optional[Trace]) -> Optional[Dict]:
    if trace is None:
        return None
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
