"""Runtime calls that wait for the device (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize) inside the program's
dt4ir.eval.step spans, over the dt4ir.env.admm spans of the traced window
(portbench/spans.py)."""
from portbench.spans import syncs_per_step


def read(run):
    return syncs_per_step(run)
