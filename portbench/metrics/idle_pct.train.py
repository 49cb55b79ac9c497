"""The device's idle share of an untraced micro-step: 1 - the union of the
traced micro-step's kernel intervals over the untraced micro-steps' mean wall
time, %."""
from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
