"""The mean length of the program's dt4ir.restormer spans (the host's issue
time of one Restormer forward: in the evaluator on CUDA, the copies in, one
graph replay and the copy out), in ms. None where the program records no
such span."""
from portbench.spans import named

RESTORMER = "dt4ir.restormer"     # the port's utils/profiling.py:RESTORMER


def read(run):
    spans = named(run, RESTORMER)
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
