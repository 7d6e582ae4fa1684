"""The self time of the dt4ir.env.admm spans (less their dt4ir.unet
spans): the FFTs, K2 and the masked merges, in ms over the ADMM spans
(portbench/spans.py)."""
from portbench.spans import env_issue_ms_per_step


def read(run):
    return env_issue_ms_per_step(run)
