"""Mean device ms (a CUDA event pair on the step's stream) of the
``optimizer`` span (the global norm, the non-finite guard, the
accumulation, and the update and EMA on one micro-step of each cycle) over
the window's untraced micro-steps, whole cycles."""
from portbench import spans


def read(ctx):
    return spans.mean_per_unit(spans.window_micro_steps(), "optimizer", spans.device_ms)
