"""Mean host ms of the ``inputs`` span (the call's host work before prep:
checks, tokenising, image preprocessing, the parts, the int8 weights' check,
the graph cache's trim) over the window's untraced requests."""
from portbench import spans


def read(ctx):
    return spans.mean_per_unit(spans.untraced_requests(ctx), "inputs", spans.host_ms)
