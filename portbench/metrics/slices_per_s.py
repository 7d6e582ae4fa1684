"""Offline evaluation throughput: every slice restored in the window over
the window's length (host clock; the window ends on a call boundary)."""


def read(run):
    if run.kind != "eval_closed" or run.window_s <= 0:
        return None
    return run.slices / run.window_s
