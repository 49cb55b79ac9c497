"""The share of its roofline that ``kernels/int8_matmul.py``'s kernel reaches in
the traced request, %."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "int8_matmul")
