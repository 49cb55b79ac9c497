"""K1, the flash attention forward (``csrc/flash_attention.cu``): every
UNet attention site with at least 128 keys (self-attention, the
I2V-Adapter's attention to the first frame), in bfloat16.  Counted: the
two products, q, k, v read once and the output written once."""

PATTERNS = ("flash_fwd",)
PEAK = "bf16_flops"
UNET_MODULES = ("attn1", "i2v_adapter", "attn2", "attn2_ip")


def work(site):
    """(operations, bytes) of one launch at ``site``, or None when the
    site is not this kernel's."""
    if site.kind != "attention" or site.module not in UNET_MODULES or site.nk < 128:
        return None
    return site.ops, 2 * (2 * site.bq * site.nq * site.c + 2 * site.bkv * site.nk * site.c)
