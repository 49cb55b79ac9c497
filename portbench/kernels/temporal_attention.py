"""K2, the channel-major temporal attention (``csrc/temporal_attention.cu``):
the motion modules' frame attention where a frame has at least 128
tokens, in bfloat16.  Counted: the two products, q, k, v read once and
the output written once."""

PATTERNS = ("temporal_fwd", "temporal_mma")
PEAK = "bf16_flops"


def work(site):
    if site.kind != "attention" or site.axis != "temporal" or site.res * site.res < 128:
        return None
    return site.ops, 2 * 4 * site.bq * site.nq * site.c
