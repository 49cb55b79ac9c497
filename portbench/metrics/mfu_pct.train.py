"""The whole micro-step's share of the chip's bf16 peak: the towers and
the encode, the UNet's forward and backward (no recompute)."""
from portbench.readers import train_mfu


def read(ctx):
    return train_mfu(ctx)
