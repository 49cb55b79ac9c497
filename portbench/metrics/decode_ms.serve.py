"""Mean ms of the VAE decode (``last_timings["decode_ms"]``, synchronised)
over the window's untraced requests."""
from portbench.readers import mean_of


def read(ctx):
    return mean_of(ctx.get("requests", []), lambda r: r["timings"].get("decode_ms"))
