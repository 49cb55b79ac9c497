"""K2, the channel-major temporal attention (``csrc/temporal_attention.cu``),
at SVD's frame attention: every ``temporal_attn1`` site of ``work_svd.py``
whose frames hold at least 128 positions (``site.m``), in bfloat16.
Counted: the two products, q, k, v read once and the output written
once."""

PATTERNS = ("temporal_fwd", "temporal_mma")
PEAK = "bf16_flops"


def work(site):
    if site.kind != "attention" or site.module != "temporal_attn1" or site.m < 128:
        return None
    return site.ops, 2 * 4 * site.bq * site.nq * site.c
