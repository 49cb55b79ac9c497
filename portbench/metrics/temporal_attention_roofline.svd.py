"""K2's share of its roofline at SVD's frame attention over 25 frames
(``kernels/temporal_attention_svd.py``), %."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "temporal_attention_svd")
