"""``mfu.eval`` of a bfloat16 cell: model FLOPs a slice
(portbench/counts.py:slice_flops) times the traced window's slices over its
wall time, over the bfloat16 peak."""
from portbench.readers import step_mfu_pct


def read(run):
    return step_mfu_pct(run)
