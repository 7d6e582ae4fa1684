"""Shared arithmetic of the metric readers (``metrics/<name>.py``).

Each reader takes the :class:`.drive.Run` of a run and returns its number,
or None where the run has nothing to read (another kind of traffic, or no
trace). None of them returns 0 for a share of a roofline or a peak that
was not measured.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from . import counts
from .trace import union_s


def p95_ms(run, kind: str, per_call: Optional[int] = None,
           untraced: bool = False) -> Optional[float]:
    """The 95th percentile of the window's latencies (linear
    interpolation), for runs of ``kind`` (and ``per_call`` slices a
    call); with ``untraced``, of the calls made outside the profiler."""
    if run.kind != kind or not run.latencies_ms:
        return None
    if per_call is not None and run.per_call != per_call:
        return None
    lat = run.latencies_ms
    if untraced and run.per_call:
        lat = lat[run.traced_slices // run.per_call:]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95))


def traced_eval(run) -> bool:
    return run.kind == "eval_closed" and run.trace is not None \
        and run.trace.busy_s() > 0


def unet_roofline_pct(run) -> Optional[float]:
    """The prior's bound at the call's batch (its module's counts) over
    the device time of the ops launched under the ``portbench.unet``
    spans, in %."""
    if not traced_eval(run) or not run.trace.spans:
        return None
    device_s = run.trace.unet_device_s()
    if device_s <= 0:
        return None
    bound = counts.prior_bound_s(run.config, run.per_call, run.prior)
    return 100.0 * len(run.trace.spans) * bound / device_s


def ops_roofline_pct(run, match: str,
                     bound_s: Callable[[dict, int], float]
                     ) -> Optional[float]:
    """A kernel's roofline share, in %: ``bound_s(config, per_call)``, the
    least time of the kernel's work in one prior call, times the number
    of ``portbench.unet`` calls, over the device time of the traced ops
    whose name contains ``match``. None where no op matched."""
    if not traced_eval(run) or not run.trace.spans:
        return None
    t0, t1 = run.trace.window
    device_s = union_s((max(a, t0), min(b, t1))
                       for a, b, name in run.trace.device
                       if match in name and min(b, t1) > max(a, t0))
    if device_s <= 0:
        return None
    return 100.0 * len(run.trace.spans) \
        * bound_s(run.config, run.per_call) / device_s


def step_mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the traced window's slices over its wall time, as a
    share of the compute dtype's peak, in %."""
    if not traced_eval(run) or run.traced_slices <= 0:
        return None
    rate = counts.slice_flops(run.config, run.prior) * run.traced_slices \
        / run.trace.window_s
    return 100.0 * rate / counts.PEAK_FLOPS[run.config["dtype"]]


def idle_pct(run) -> Optional[float]:
    """Share of the traced window in which no device op ran, in %."""
    if run.trace is None or run.trace.busy_s() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
