"""The whole step's share of the peak: model FLOPs a slice
(portbench/counts.py:slice_flops) times the traced window's slices over its
wall time, over the compute dtype's peak."""
from portbench.readers import step_mfu_pct


def read(run):
    return step_mfu_pct(run)
