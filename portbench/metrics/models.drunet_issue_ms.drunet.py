"""The mean length of the program's dt4ir.drunet spans (the host's issue
time of one DRUNet forward), in ms. None where the program records no such
span."""
from portbench.spans import named

DRUNET = "dt4ir.drunet"     # the port's utils/profiling.py:DRUNET


def read(run):
    spans = named(run, DRUNET)
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
