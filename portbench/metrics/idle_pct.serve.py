"""The device's idle share of an untraced request: 1 - the union of the
traced request's kernel intervals over the untraced requests' mean wall
time, %."""
from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
