"""Mean device ms of a denoise step (``last_timings["step_ms"]``, CUDA
events around each replayed step) over the window's untraced requests."""
import numpy as np

from portbench.readers import mean_of


def read(ctx):
    return mean_of(ctx.get("requests", []), lambda r: float(np.mean(r["timings"]["step_ms"])))
