"""K3, the flash attention backward (``csrc/flash_attention_bwd.cu``): the
backward of every UNet attention site with at least 1024 keys whose inputs
carry a gradient, in bfloat16.  Counted: the four products of dV, dP, dQ
and dK, q, k, v, o and dO read once, dq, dk and dv written once."""

PATTERNS = ("bwd_dq", "bwd_dkv", "bwd_prep")
PEAK = "bf16_flops"
UNET_MODULES = ("attn1", "i2v_adapter", "attn2", "attn2_ip")


def work(site):
    if site.kind != "attention_bwd" or site.module not in UNET_MODULES or site.nk < 1024:
        return None
    q, kv = site.bq * site.nq * site.c, site.bkv * site.nk * site.c
    return site.ops, 2 * (3 * q + 2 * kv) + 2 * (q + 2 * kv)
