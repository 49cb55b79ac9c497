"""The share of its roofline that ``kernels/flash_attention_bwd.py``'s kernel reaches in
the traced micro-step, %."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "flash_attention_bwd")
