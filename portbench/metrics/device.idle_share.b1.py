"""Share of the traced window with no kernel, copy or set running on the
device (the union of the device intervals)."""
from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
