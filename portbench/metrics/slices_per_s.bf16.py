"""Offline evaluation throughput of a bfloat16 cell: every slice restored
in the window over the window's length (host clock; the window ends on a
call boundary). ``slices_per_s`` under a bound of its own: the bfloat16
windows are host-bound and spread wider than the float32 ones."""


def read(run):
    if run.kind != "eval_closed" or run.window_s <= 0:
        return None
    return run.slices / run.window_s
