"""The mean length of the program's dt4ir.unet spans (one U-Net forward's
launches), in ms (portbench/spans.py)."""
from portbench.spans import unet_issue_ms


def read(run):
    return unet_issue_ms(run)
