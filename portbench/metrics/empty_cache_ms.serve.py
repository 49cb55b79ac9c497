"""Mean host ms of the ``empty_cache`` span (the scan loop's
``torch.cuda.empty_cache()``, which hands the previous decode's cached
blocks back to the card) over the window's untraced requests."""
from portbench import spans


def read(ctx):
    return spans.mean_per_unit(spans.untraced_requests(ctx), "empty_cache", spans.host_ms)
