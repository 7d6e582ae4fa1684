"""``device.idle_share.eval`` of a bfloat16 cell: share of the traced
window with no kernel, copy or set running on the device."""
from portbench.readers import idle_pct


def read(run):
    return idle_pct(run)
