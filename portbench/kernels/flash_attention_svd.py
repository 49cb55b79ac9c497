"""K1, the flash attention forward (``csrc/flash_attention.cu``), at SVD's
spatial self-attention: every ``attn1`` site of ``work_svd.py`` with at
least 128 keys (any latent shape: the sites count positions, not a square
side), in bfloat16.  Counted: the two products, q, k, v read once and the
output written once."""

PATTERNS = ("flash_fwd",)
PEAK = "bf16_flops"


def work(site):
    if site.kind != "attention" or site.module != "attn1" or site.nk < 128:
        return None
    return site.ops, 2 * (2 * site.bq * site.nq * site.c + 2 * site.bkv * site.nk * site.c)
