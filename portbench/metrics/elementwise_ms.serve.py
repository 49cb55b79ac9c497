"""Device ms per denoise step in the elementwise and reduction / norm
categories (the traced request's step stream)."""
from portbench.readers import elementwise


def read(ctx):
    return elementwise(ctx)
