"""Mean device ms (a CUDA event pair on the step's stream) of the
``forward`` span (the UNet's forward and the loss) over the window's
untraced micro-steps."""
from portbench import spans


def read(ctx):
    return spans.mean_per_unit(spans.window_micro_steps(), "forward", spans.device_ms)
