"""K1's share of its roofline at SVD's spatial self-attention sites
(``kernels/flash_attention_svd.py``), %."""
from portbench.readers import roofline


def read(ctx):
    return roofline(ctx, "flash_attention_svd")
