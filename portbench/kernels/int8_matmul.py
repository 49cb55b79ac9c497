"""K7, the int8 matmul (``csrc/int8_matmul.cu``): the serving default's
stride-2 downsample convs as an int8 im2col times the weights.  Counted:
int8 operations, the int8 columns and weights read once, the bfloat16
output written once."""

PATTERNS = ("int8_mm",)
PEAK = "int8_ops"


def work(site):
    if site.kind != "conv" or not site.int8 or site.stride != 2:
        return None
    return site.ops, site.m * site.k + site.k * site.n + 2 * site.m * site.n
