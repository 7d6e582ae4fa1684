"""The dt4ir.policy.step spans (buffer writes, the cached encoder, the two
DT forwards, the masked merges), summed, in ms over the dt4ir.env.admm
spans (portbench/spans.py)."""
from portbench.spans import policy_issue_ms_per_step


def read(run):
    return policy_issue_ms_per_step(run)
