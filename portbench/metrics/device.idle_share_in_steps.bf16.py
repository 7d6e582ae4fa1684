"""``device.idle_share_in_steps.eval`` of a bfloat16 cell: the device's
idle time inside the program's dt4ir.eval.step spans, over the traced
window, in %, at 63 slices a call (portbench/spans.py)."""
from portbench.spans import idle_in_steps_pct


def read(run):
    return idle_in_steps_pct(run)
