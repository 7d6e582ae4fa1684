"""Shared arithmetic of the readers of the program's own spans.

The port names its work with ``record_function`` spans under the prefix
``dt4ir.`` (Chrome category ``user_annotation``), recorded only while a
profiler runs, so they land in :class:`.trace.Trace`'s ``host`` events on
the clock of its device events. The names are copied here, as the
interval arithmetic is in :mod:`.trace`, so that the yardstick cannot move
with the program. Every reader returns None on a run with no trace, with
no device op in it (a run on the CPU), or without these spans (a port that
does not record them).

"ADMM steps" are the ``dt4ir.env.admm`` spans of the traced window: the
per-step metrics divide by their count.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

from .trace import gaps, union_s

STEP = "dt4ir.eval.step"        # one iteration of the greedy loop
SYNC = "dt4ir.eval.sync"        # a device-to-host read of the loop
ADMM = "dt4ir.env.admm"         # one ADMM iteration and its merge
UNET = "dt4ir.unet"             # one U-Net forward
POLICY = "dt4ir.policy.step"    # the buffer writes and two DT forwards
# The CUDA runtime calls that wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")

Interval = Tuple[float, float]


def named(run, *names: str) -> List[Interval]:
    """(start, end) of the traced window's host events of these names,
    sorted; empty without a trace or where no device op ran."""
    if run.trace is None or run.trace.busy_s() <= 0:
        return []
    return sorted((a, b) for a, b, n in run.trace.host if n in names)


def within(events: Iterable[Interval], parents: List[Interval]
           ) -> List[Interval]:
    """The events that lie inside one of ``parents`` (sorted, disjoint)."""
    starts = [a for a, _ in parents]
    out = []
    for a, b in events:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= parents[i][1]:
            out.append((a, b))
    return out


def covered_s(intervals: Iterable[Interval], cover: Iterable[Interval]
              ) -> float:
    """Length of the union of ``intervals`` inside the union of ``cover``."""
    def merged(xs):
        out: List[List[float]] = []
        for a, b in sorted(xs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    xs, cs = merged(intervals), merged(cover)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(cs):
        lo = max(xs[i][0], cs[j][0])
        hi = min(xs[i][1], cs[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < cs[j][1]:
            i += 1
        else:
            j += 1
    return total


def _steps(run) -> Optional[Tuple[List[Interval], int]]:
    """The loop's iteration spans and the count of ADMM steps, or None
    where the window has neither."""
    steps, n_admm = named(run, STEP), len(named(run, ADMM))
    if not steps or not n_admm:
        return None
    return steps, n_admm


def syncs_per_step(run) -> Optional[float]:
    """The runtime calls that wait for the device inside the loop's
    iterations, over ADMM steps."""
    found = _steps(run)
    if found is None:
        return None
    steps, n_admm = found
    return len(within(named(run, *SYNC_CALLS), steps)) / n_admm


def issue_ms_per_step(run) -> Optional[float]:
    """The loop's iterations less their waits on the device (the sync
    spans and the synchronizing runtime calls inside them, as a union),
    in ms over ADMM steps."""
    found = _steps(run)
    if found is None:
        return None
    steps, n_admm = found
    waits = within(named(run, SYNC, *SYNC_CALLS), steps)
    total = sum(b - a for a, b in steps)
    return 1e3 * (total - union_s(waits)) / n_admm


def env_issue_ms_per_step(run) -> Optional[float]:
    """The ADMM spans' self time (less their U-Net spans), in ms over ADMM
    steps."""
    admm = named(run, ADMM)
    if not admm:
        return None
    total = sum(b - a for a, b in admm)
    return 1e3 * (total - covered_s(named(run, UNET), admm)) / len(admm)


def unet_issue_ms(run) -> Optional[float]:
    """The mean length of a U-Net span, in ms."""
    unet = named(run, UNET)
    if not unet:
        return None
    return 1e3 * sum(b - a for a, b in unet) / len(unet)


def policy_issue_ms_per_step(run) -> Optional[float]:
    """The policy step spans, summed, in ms over ADMM steps."""
    n_admm = len(named(run, ADMM))
    policy = named(run, POLICY)
    if not n_admm or not policy:
        return None
    return 1e3 * sum(b - a for a, b in policy) / n_admm


def idle_in_steps_pct(run) -> Optional[float]:
    """The device's idle time inside the loop's iterations, as a share of
    the traced window, in %."""
    steps = named(run, STEP)
    if not steps:
        return None
    t0, t1 = run.trace.window
    idle = gaps([(a, b) for a, b, _ in run.trace.device], t0, t1)
    return 100.0 * covered_s(idle, steps) / run.trace.window_s
