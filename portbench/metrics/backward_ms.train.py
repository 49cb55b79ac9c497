"""Mean device ms (a CUDA event pair on the step's stream) of the
``backward`` span (the gradients, the checkpointed blocks' recompute
included) over the window's untraced micro-steps."""
from portbench import spans


def read(ctx):
    return spans.mean_per_unit(spans.window_micro_steps(), "backward", spans.device_ms)
