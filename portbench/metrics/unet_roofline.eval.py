"""The U-Net's roofline share under the traced calls: the least time its
work at the call's batch needs (portbench/counts.py) over the device time
of the ops launched under the portbench.unet spans."""
from portbench.readers import unet_roofline_pct


def read(run):
    return unet_roofline_pct(run)
