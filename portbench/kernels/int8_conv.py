"""The int8 3x3 convolution (``csrc/int8_conv3x3.cu``): the serving
default's stride-1 resnet and upsample convs of the UNet and the VAE
decoder.  Counted: int8 operations, the bfloat16 input read once (it is
quantised while staged), the int8 weights read once, the bfloat16 output
written once."""

PATTERNS = ("int8_conv3x3_wgmma",)
PEAK = "int8_ops"


def work(site):
    if site.kind != "conv" or not site.int8 or site.stride != 1:
        return None
    cin = site.k // 9
    return site.ops, 2 * site.m * cin + site.k * site.n + 2 * site.m * site.n
