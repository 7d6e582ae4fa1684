"""DRUNet's forward convolutions against their roofline, in %: the least
time of their FLOPs a call (``priors/drunet.py:fprop_flops``: the 58 3x3
convs, 97.7 % of DRUNet's FLOPs, and the three 2x2 stride-2 ones, at the
call's batch, over the bfloat16 peak) times the calls, over the device
time of the traced ops whose name holds :data:`MATCH`.

On the H100 (PyTorch 2.11, cuDNN's bfloat16 NHWC engines) every such
convolution but one runs as ``sm90_xmma_fprop_implicit_gemm_bf16bf16_...
nhwckrsc_nhwc...`` or, the head's or the tail's, as ``sm80_xmma_fprop_
implicit_gemm_bf16bf16_...``; the other of those two runs as a CUTLASS
kernel outside the match (under 0.06 % of the FLOPs). The DT's state
encoder matches nothing: the matched device time of a window equals the
calls times the matched kernels of one DRUNet forward, profiled alone.
"""
from portbench import counts
from portbench.readers import ops_roofline_pct

MATCH = "xmma_fprop_implicit_gemm_bf16"


def read(run):
    prior = run.prior
    if not hasattr(prior, "fprop_flops"):
        return None
    peak = counts.PEAK_FLOPS[run.config["dtype"]]
    return ops_roofline_pct(
        run, MATCH, lambda cfg, batch: batch * prior.fprop_flops(cfg) / peak)
