"""95th percentile of the time to restore one slice alone, over every
call of a one-slice closed loop that ran outside the profiler (host clock,
synchronised). Too unsteady from run to run to be held to a bound, it
stands beside ``single_slices_per_s``, the rate of the same calls."""
from portbench.readers import p95_ms


def read(run):
    return p95_ms(run, "eval_closed", per_call=1, untraced=True)
