"""The share of its roofline that ``kernels/temporal_attention.py``'s kernel reaches in
the traced micro-step, %."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "temporal_attention")
