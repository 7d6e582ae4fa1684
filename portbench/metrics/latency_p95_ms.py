"""95th percentile, over every request due in the window, of the time from
its scheduled send to the resolution of its future; a request that failed
or never resolved counts as infinitely late (host clock)."""
from portbench.readers import p95_ms


def read(run):
    return p95_ms(run, "serve_open")
