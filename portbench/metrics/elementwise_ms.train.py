"""Device ms per micro-step in the elementwise and reduction / norm
categories (the traced micro-step)."""
from portbench import trace
from portbench.readers import category_ms


def read(ctx):
    return category_ms(ctx, trace.ELEMENTWISE)
