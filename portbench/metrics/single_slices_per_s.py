"""Single-slice restoration throughput: every slice of a one-slice closed
loop restored in the window over the window's length (host clock; the
window ends on a call boundary)."""


def read(run):
    if run.kind != "eval_closed" or run.per_call != 1 or run.window_s <= 0:
        return None
    return run.slices / run.window_s
