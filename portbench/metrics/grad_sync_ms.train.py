"""Mean device ms (a CUDA event pair on the step's stream) of the
``grad_sync`` span (the gradients summed and the loss all-reduced over the
ranks) over rank 0's untraced window micro-steps; None where the program
has no such span."""


def read(ctx):
    return ctx.get("grad_sync_ms")
