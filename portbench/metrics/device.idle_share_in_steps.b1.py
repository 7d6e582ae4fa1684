"""The device's idle time inside the program's dt4ir.eval.step spans (the
gaps between its kernels, copies and sets, intersected with the spans'
union), over the traced window, in %, at one slice a call
(portbench/spans.py)."""
from portbench.spans import idle_in_steps_pct


def read(run):
    return idle_in_steps_pct(run)
