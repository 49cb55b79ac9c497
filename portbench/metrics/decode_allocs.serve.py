"""Mean count of the CUDA caching allocator's device allocations
(``num_device_alloc``, read at the ``decode`` span's edges) in a request's
VAE decode, over the window's untraced requests; none on the CPU."""
from portbench import spans


def read(ctx):
    return spans.mean_per_unit(spans.untraced_requests(ctx), "decode", spans.device_allocs)
