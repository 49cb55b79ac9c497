"""Mean host ms of the ``finish`` span (the frames' copy to the host, the
finite check and the uint8 conversion) over the window's untraced
requests."""
from portbench import spans


def read(ctx):
    return spans.mean_per_unit(spans.untraced_requests(ctx), "finish", spans.host_ms)
