"""``unet_roofline.eval`` of a bfloat16 cell: the least time the U-Net's
work at the call's batch needs (portbench/counts.py) over the device time
of the ops launched under the portbench.unet spans."""
from portbench.readers import unet_roofline_pct


def read(run):
    return unet_roofline_pct(run)
