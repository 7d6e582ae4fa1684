"""Kernel K7 (``mdta_gram``: Restormer's attention maps) against its
roofline, in %: its least time a call (``priors/restormer.py:
gram_bound_s``: q and k of every block read once and the float32 maps
written once over 3.35 TB/s, above the Gram's FLOPs over the bfloat16
peak), times the calls, over the device time of the traced ops whose name
holds :data:`MATCH`: K7's two passes, ``mdta_gram_partial_*`` and
``mdta_gram_softmax``, and no other op of the window. None where no op
matched (a program without K7)."""
from portbench.readers import ops_roofline_pct

MATCH = "mdta_gram"


def read(run):
    prior = run.prior
    if not hasattr(prior, "gram_bound_s"):
        return None
    return ops_roofline_pct(run, MATCH, prior.gram_bound_s)
