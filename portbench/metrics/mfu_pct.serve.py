"""The whole request's share of the chip's bf16 peak: every UNet
evaluation, the towers, the encode and the decode."""
from portbench.readers import serve_mfu


def read(ctx):
    return serve_mfu(ctx)
