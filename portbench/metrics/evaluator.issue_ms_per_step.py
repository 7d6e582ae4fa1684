"""The host's time to issue one ADMM step: the dt4ir.eval.step spans less
the union of their dt4ir.eval.sync spans and synchronizing runtime calls,
in ms over the dt4ir.env.admm spans (portbench/spans.py)."""
from portbench.spans import issue_ms_per_step


def read(run):
    return issue_ms_per_step(run)
