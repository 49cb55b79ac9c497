"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device
and nvcc.  The file imports no JAX, so it also runs on a CUDA machine that
has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py

Errors are max |kernel - plain| over max |plain| with no floor: attention
outputs are well under 1, where a floor of 1 would make the bound absolute.
"""

import math

import pytest
import torch

from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.ops import conv3x3 as C
from i2v_adapter_tpu_torch.ops import profile_int8_dense as I8
from i2v_adapter_tpu_torch.ops.norms import fold_gn_affine

TOL_FP32 = 1e-4
# bf16 output: one ulp is up to 2^-7 of max |plain|, and p is rounded to
# bf16 before p.v on both sides but summed in another order
TOL_BF16 = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from i2v_adapter_tpu_torch.ops import _build

    try:
        _build.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    # the plain fp32 convolution is a reference only in full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _relerr(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _flash_inputs(dev, bq, rep, n, h, d, dtype, seed, nk=None):
    """q as a strided view of a wider (fused-projection-like) buffer, k/v
    of batch bq // rep with ``nk`` keys (default n)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nk = n if nk is None else nk
    q = torch.randn(bq, n, 2 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
    k = torch.randn(bq // rep, nk, h, d, generator=g, device=dev)
    v = torch.randn(bq // rep, nk, h, d, generator=g, device=dev)
    return tuple(x.to(dtype) for x in (q, k, v))


# (kv_repeat, nq, nk, d): the serving and training head dims at both
# kv_repeat values, ragged token counts that no tile size divides, and the
# full_face IP attention's 257 keys at every level (the mid block's 64
# queries are half of the D = 160 query tile)
FLASH_CASES = [(1, 1024, 1024, 80), (16, 577, 577, 40), (1, 256, 256, 160), (16, 256, 256, 160),
               (16, 1024, 1024, 40), (1, 577, 130, 40), (16, 130, 577, 80), (2, 130, 130, 160),
               (1, 4096, 257, 40), (1, 1024, 257, 80), (1, 256, 257, 160), (1, 64, 257, 160)]


@pytest.mark.gpu
@pytest.mark.parametrize("static_max", [64.0, 0.0])
@pytest.mark.parametrize("rep,nq,nk,d", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, rep, nq, nk, d, static_max):
    """fp32: the scalar kernel, output and log2 logsumexp."""
    q, k, v = _flash_inputs(cuda_device, 16, rep, nq, 2, d, torch.float32, seed=nq + d, nk=nk)
    before = A.flash_attention.launches
    got, lse = A.flash_attention(q, k, v, kv_repeat=rep, static_max=static_max, with_lse=True)
    assert A.flash_attention.launches == before + 1
    want, want_lse = A._plain_attention(q, k, v, rep, 1 / math.sqrt(d), static_max, with_lse=True)
    assert _relerr(got, want) < TOL_FP32
    assert _relerr(lse, want_lse) < TOL_FP32


@pytest.mark.gpu
@pytest.mark.parametrize("static_max", [64.0, 0.0])
@pytest.mark.parametrize("rep,nq,nk,d", FLASH_CASES)
def test_flash_mma_kernel_matches_plain_on_card(cuda_device, rep, nq, nk, d, static_max):
    """bf16: the wgmma kernel (32 frame-evals, 8 heads), q a strided view of
    a wider buffer; the logsumexp is fp32 from fp32 scores on both sides."""
    q, k, v = _flash_inputs(cuda_device, 32, rep, nq, 8, d, torch.bfloat16, seed=rep + d, nk=nk)
    before = A.flash_attention.launches
    got, lse = A.flash_attention(q, k, v, kv_repeat=rep, static_max=static_max, with_lse=True)
    assert A.flash_attention.launches == before + 1
    want, want_lse = A._plain_attention(q, k, v, rep, 1 / math.sqrt(d), static_max, with_lse=True)
    assert torch.isfinite(got).all()
    assert _relerr(got, want) < TOL_BF16
    assert _relerr(lse, want_lse) < TOL_FP32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_anchored_window_matches_plain_on_card(cuda_device, dtype):
    """The cross-frame attention of temporal tiling's anchored windows: 17
    frames per clip, two clips (a CFG-doubled window), kv_repeat = 17."""
    q, k, v = _flash_inputs(cuda_device, 34, 17, 1024, 8, 40, dtype, seed=17)
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kv_repeat=17, static_max=64.0)
    assert A.flash_attention.launches == before + 1
    want = A._plain_attention(q, k, v, 17, 1 / math.sqrt(40), 64.0)
    assert _relerr(got, want) < (TOL_FP32 if dtype == torch.float32 else TOL_BF16)


@pytest.mark.gpu
def test_flash_kernel_refuses_unaligned_bf16(cuda_device):
    """bf16 rows the tensor-core kernel cannot read raise; nothing launches."""
    q = torch.randn(2, 256, 2, 36, device=cuda_device).to(torch.bfloat16)
    before = A.flash_attention.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        A.flash_attention(q, q, q)
    assert A.flash_attention.launches == before
    lse = torch.zeros(2 * 2, 256, device=cuda_device)
    before = A.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        A.flash_attention_bwd(q, q, q, q, q, lse)
    assert A.flash_attention_bwd.launches == before


# (fq, f, s, c, strided q): 8 heads, so d = 40, 80, 160 at C = 320, 640,
# 1280; F = 16 and 32, the anchored windows' 17, Fq < F, token counts no
# tile divides (1, 130, 577), and q as a view of a wider buffer
TEMPORAL_CASES = [
    (16, 16, 1024, 320, False), (16, 16, 1024, 640, False), (16, 16, 256, 1280, False),
    (17, 17, 4096, 320, False), (17, 17, 1024, 640, False),
    (32, 32, 128, 640, False), (32, 32, 256, 1280, False), (8, 16, 576, 640, False),
    (16, 16, 1, 640, False), (16, 16, 130, 320, False), (16, 16, 577, 1280, False),
    (16, 16, 130, 640, True), (12, 20, 77, 640, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fq,f,s,c,strided", TEMPORAL_CASES)
def test_temporal_kernel_matches_plain_on_card(cuda_device, fq, f, s, c, strided, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    if strided:
        q = torch.randn(2, fq, s, 2 * c, generator=g, device=cuda_device).to(dtype)[..., c:]
    else:
        q = torch.randn(2, fq, s, c, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, f, s, c, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, f, s, c, generator=g, device=cuda_device).to(dtype)
    before = A.temporal_attention_cs.launches
    got = A.temporal_attention_cs(q, k, v, 8)
    assert A.temporal_attention_cs.launches == before + 1
    want = A.temporal_attention_plain(q, k, v, 8)
    assert _relerr(got, want) < (TOL_FP32 if dtype == torch.float32 else TOL_BF16)


def _grad_inputs(dev, bq, rep, n, h, d, dtype, seed):
    """q as a strided view of a wider buffer (as the projections give it),
    k/v of batch bq // rep, g random; o and lse from K1 itself."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bq, n, 2 * h * d, generator=g, device=dev)[..., : h * d].unflatten(-1, (h, d))
    k = torch.randn(bq // rep, n, h, d, generator=g, device=dev)
    v = torch.randn(bq // rep, n, h, d, generator=g, device=dev)
    do = torch.randn(bq, n, h, d, generator=g, device=dev)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    o, lse = A.flash_attention(q, k, v, kv_repeat=rep, static_max=0.0, with_lse=True)
    return q, k, v, o, do, lse


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,n,d", [(1, 1024, 40), (16, 1024, 40), (1, 577, 80), (16, 577, 160),
                                     (2, 1030, 80), (16, 577, 80), (1, 130, 40), (16, 130, 80)])
def test_flash_bwd_kernel_matches_plain_on_card(cuda_device, dtype, rep, n, d):
    """K3 vs its plain version from the same o and lse: fp32 (scalar
    kernels) and bf16 (wgmma kernels at D <= 96, mma.sync at 160),
    kv_repeat fan-in, ragged N."""
    q, k, v, o, do, lse = _grad_inputs(cuda_device, 16, rep, n, 2, d, dtype, seed=n + d + rep)
    before = A.flash_attention_bwd.launches
    got = A.flash_attention_bwd(q, k, v, o, do, lse, kv_repeat=rep)
    assert A.flash_attention_bwd.launches == before + 1
    want = A._plain_flash_backward(q, k, v, o, do, lse, rep, 1 / math.sqrt(d))
    tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
    for name, a, b in zip("qkv", got, want):
        assert torch.isfinite(a).all(), f"d{name}"
        assert _relerr(a, b) < tol, f"d{name}: {_relerr(a, b)}"


# the latent zoo's attention sites (fp32, 4 heads, exact running max): the
# self-attention of SimpleUNet / SimpleUNet3D at 256 tokens with D = 32
# (widths 128 / 4) and D = 64 (256 / 4), at 1024 tokens with D = 32, where
# training also runs K3
ZOO_FLASH_CASES = [(32, 256, 32), (8, 256, 64), (8, 1024, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("bq,n,d", ZOO_FLASH_CASES)
def test_flash_kernel_at_zoo_shapes_on_card(cuda_device, bq, n, d):
    """K1's scalar fp32 path at the zoo's head dims, output and log2
    logsumexp."""
    q, k, v = _flash_inputs(cuda_device, bq, 1, n, 4, d, torch.float32, seed=bq + n + d)
    before = A.flash_attention.launches
    got, lse = A.flash_attention(q, k, v, static_max=0.0, with_lse=True)
    assert A.flash_attention.launches == before + 1
    want, want_lse = A._plain_attention(q, k, v, 1, 1 / math.sqrt(d), 0.0, with_lse=True)
    assert _relerr(got, want) < TOL_FP32 and _relerr(lse, want_lse) < TOL_FP32


@pytest.mark.gpu
def test_flash_bwd_kernel_at_zoo_shape_on_card(cuda_device):
    """K3's scalar fp32 path at the zoo's training site (1024 tokens, D =
    32, 4 heads, batch 8), and FlashAttentionFn taking it there."""
    q, k, v, o, do, lse = _grad_inputs(cuda_device, 8, 1, 1024, 4, 32, torch.float32, seed=7)
    got = A.flash_attention_bwd(q, k, v, o, do, lse)
    want = A._plain_flash_backward(q, k, v, o, do, lse, 1, 1 / math.sqrt(32))
    for name, a, b in zip("qkv", got, want):
        assert torch.isfinite(a).all() and _relerr(a, b) < TOL_FP32, f"d{name}: {_relerr(a, b)}"
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    before = dict(A.launch_counts())
    got = torch.autograd.grad(A.dot_product_attention(q, k, v, static_max=0.0), (q, k, v), do)
    counts = A.launch_counts()
    assert counts["flash_attention"] - before["flash_attention"] == 1
    assert counts["flash_attention_bwd"] - before["flash_attention_bwd"] == 1
    want = torch.autograd.grad(A.xla_attention(q, k, v), (q, k, v), do)
    for name, a, b in zip("qkv", got, want):
        assert _relerr(a, b) < TOL_FP32, f"d{name}"


@pytest.mark.gpu
def test_flash_attention_fn_grads_on_card(cuda_device):
    """FlashAttentionFn on the card: K1 + K3 at nk >= 1024, K1 + the plain
    backward below it, both against autograd of the plain attention (fp32)."""
    for n in (1024, 256):
        q, k, v, _, do, _ = _grad_inputs(cuda_device, 8, 4, n, 2, 40, torch.float32, seed=n)
        q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
        before = dict(A.launch_counts())
        out = A.dot_product_attention(q, k, v, kv_repeat=4)
        got = torch.autograd.grad(out, (q, k, v), do)
        counts = A.launch_counts()
        assert counts["flash_attention"] == before["flash_attention"] + 1
        assert counts["flash_attention_bwd"] == before["flash_attention_bwd"] + (n >= 1024)
        ref = A.xla_attention(q, k, v, kv_repeat=4)
        want = torch.autograd.grad(ref, (q, k, v), do)
        for name, a, b in zip("qkv", got, want):
            assert _relerr(a, b) < TOL_FP32, f"n={n} d{name}"


@pytest.mark.gpu
def test_temporal_attention_fn_grads_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(2, 16, 256, 320, generator=g, device=cuda_device).requires_grad_()
               for _ in range(3))
    do = torch.randn(2, 16, 256, 320, generator=g, device=cuda_device)
    before = A.temporal_attention_cs.launches
    got = torch.autograd.grad(A.temporal_attention(q, k, v, heads=8), (q, k, v), do)
    assert A.temporal_attention_cs.launches == before + 1
    want = torch.autograd.grad(A.temporal_attention_plain(q, k, v, 8), (q, k, v), do)
    for a, b in zip(got, want):
        assert _relerr(a, b) < TOL_FP32


# ---------------------------------------------------------------------------
# K1 on row-major storage (the reference's K5), K2 forced at small S (its K6)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,n,d", [(1, 1024, 80), (16, 577, 40), (4, 256, 160)])
def test_flash_row_major_entry_on_card(cuda_device, dtype, rep, n, d):
    """``transposed_io=False`` on (B, H, N, D) storage: no copy is made,
    the result comes back in that storage and equals the default layout's."""
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    q = torch.randn(16, 8, n, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    k = torch.randn(16 // rep, 8, n, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    v = torch.randn(16 // rep, 8, n, d, generator=g, device=cuda_device).to(dtype).transpose(1, 2)
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kv_repeat=rep, transposed_io=False)
    assert A.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    want = A._plain_attention(q, k, v, rep, 1 / math.sqrt(d), 0.0)
    assert _relerr(got, want) < (TOL_FP32 if dtype == torch.float32 else TOL_BF16)
    same = A.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_repeat=rep)
    assert torch.equal(got, same)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fq,f,s,c", [(16, 16, 64, 1280), (8, 16, 64, 1280), (16, 16, 16, 320)])
def test_temporal_kernel_forced_below_128_tokens_on_card(cuda_device, dtype, fq, f, s, c):
    g = torch.Generator(device=cuda_device).manual_seed(s + c)
    q = torch.randn(2, fq, s, c, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, f, s, c, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, f, s, c, generator=g, device=cuda_device).to(dtype)
    before = A.temporal_attention_cs.launches
    auto = A.temporal_attention(q, k, v, heads=8)  # S < 128: the einsum
    assert A.temporal_attention_cs.launches == before
    got = A.temporal_attention(q, k, v, heads=8, impl="kernel")
    assert A.temporal_attention_cs.launches == before + 1
    assert _relerr(got, auto) < (TOL_FP32 if dtype == torch.float32 else TOL_BF16)


# ---------------------------------------------------------------------------
# K4: GroupNorm-apply + SiLU + 3x3 conv
# ---------------------------------------------------------------------------


def _conv_inputs(dev, b, h, w, c, co, dtype, seed, groups=8):
    """x with a mean and a spread, a/s folded from its own GroupNorm
    statistics, weights in the model's OIHW storage passed as an HWIO view."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, h, w, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    weight = (torch.randn(co, c, 3, 3, generator=g, device=dev) / math.sqrt(9 * c)).to(dtype)
    bias = (torch.randn(co, generator=g, device=dev) * 0.1).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    a, s = fold_gn_affine(x, groups, 1e-5, gamma, beta)
    return x, a, s, weight.permute(2, 3, 1, 0), bias


CONV_SHAPES = [
    (2, 12, 8, 136, 264),   # ragged: H != W, channel tails in both tile dims
    (4, 8, 8, 320, 640),    # a 128-position tile spans two images; Cout 640: a partial n256 tile
    (9, 4, 4, 64, 96),      # ... several images, and ends inside one
    (2, 64, 64, 320, 320),  # the halo is as large as the tile; Cout 320: n160 tiles
    (1, 5, 3, 8, 8),
    (1, 3, 260, 16, 16),    # so wide that only two pixel buffers fit
    (8, 4, 4, 1280, 1280),  # H4: a tile spans several images; n256 tiles
    (2, 8, 8, 2560, 1280),  # H8, 40 channel blocks
    (2, 16, 16, 1280, 1280),
    (2, 16, 16, 640, 320),
]


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False], ids=["gn_silu_conv", "conv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_kernel_matches_plain_on_card(cuda_device, shape, dtype, fused):
    x, a, s, kernel, bias = _conv_inputs(cuda_device, *shape, dtype, seed=sum(shape))
    before = C.conv3x3_kernel.launches
    if fused:
        got = C.gn_silu_conv3x3(x, a, s, kernel, bias)
        want = C.gn_silu_conv3x3_plain(x, a, s, kernel, bias)
    else:
        got = C.conv3x3(x, kernel, bias)
        want = C.conv3x3_plain(x, kernel, bias)
    assert C.conv3x3_kernel.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got).all()
    assert _relerr(got, want) < (TOL_FP32 if dtype == torch.float32 else TOL_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_padding_is_zero_after_activation_on_card(cuda_device, dtype):
    """x = 0, a = 1, s = 2, all-ones weights: the corner sums 4 taps of
    silu(2) per channel, an edge 6, the inside 9 -- not 9 everywhere."""
    c = 64
    x = torch.zeros(2, 8, 8, c, device=cuda_device, dtype=dtype)
    a = torch.ones(2, c, device=cuda_device)
    s = torch.full((2, c), 2.0, device=cuda_device)
    kernel = torch.ones(8, c, 3, 3, device=cuda_device, dtype=dtype).permute(2, 3, 1, 0)
    out = C.gn_silu_conv3x3(x, a, s, kernel, torch.zeros(8, device=cuda_device, dtype=dtype))
    unit = float(torch.nn.functional.silu(torch.tensor(2.0)).to(dtype)) * c
    for b in range(2):
        for (yy, xx), taps in {(0, 0): 4, (0, 3): 6, (7, 7): 4, (4, 0): 6, (3, 4): 9}.items():
            assert abs(float(out[b, yy, xx, 0]) - taps * unit) <= 1e-2 * taps * unit, (b, yy, xx)


@pytest.mark.gpu
def test_conv_kernel_per_sample_prologue_on_card(cuda_device):
    """Each image of a tile that spans several uses its own a and s."""
    x, a, s, kernel, bias = _conv_inputs(cuda_device, 6, 4, 4, 32, 32, torch.bfloat16, seed=3)
    a = a * torch.arange(1, 7, device=cuda_device)[:, None]
    got = C.gn_silu_conv3x3(x, a, s, kernel, bias)
    for b in range(6):
        one = C.gn_silu_conv3x3_plain(x[b:b + 1], a[b:b + 1], s[b:b + 1], kernel, bias)
        assert _relerr(got[b:b + 1], one) < TOL_BF16, b


@pytest.mark.gpu
def test_conv_kernel_takes_hwio_storage_on_card(cuda_device):
    """A kernel stored HWIO-contiguous (not the model's OIHW view) gives
    the same result: the wrapper relays it once."""
    x, a, s, kernel, bias = _conv_inputs(cuda_device, 2, 8, 8, 64, 64, torch.bfloat16, seed=4)
    assert torch.equal(C.gn_silu_conv3x3(x, a, s, kernel.contiguous(), bias),
                       C.gn_silu_conv3x3(x, a, s, kernel, bias))


@pytest.mark.gpu
def test_conv_kernel_refuses_unaligned_bf16(cuda_device):
    x, a, s, kernel, bias = _conv_inputs(cuda_device, 1, 4, 4, 12, 8, torch.bfloat16, seed=5, groups=4)
    before = C.conv3x3_kernel.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        C.gn_silu_conv3x3(x, a, s, kernel, bias)
    assert C.conv3x3_kernel.launches == before
    # fp32 takes any channel count
    xf, kf, bf = x.float(), kernel.float(), bias.float()
    assert _relerr(C.gn_silu_conv3x3(xf, a, s, kf, bf),
                   C.gn_silu_conv3x3_plain(xf, a, s, kf, bf)) < TOL_FP32


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [True, False], ids=["GnSiluConv3x3Fn", "Conv3x3Fn"])
def test_conv_fn_grads_on_card(cuda_device, fused):
    """K4 forward, plain backward: gradients of all inputs vs autograd
    through the plain version (fp32)."""
    x, a, s, kernel, bias = _conv_inputs(cuda_device, 2, 8, 8, 32, 48, torch.float32, seed=6)
    inputs = [t.detach().clone().requires_grad_() for t in ((x, a, s, kernel, bias) if fused
                                                            else (x, kernel, bias))]
    fn, plain = (C.gn_silu_conv3x3, C.gn_silu_conv3x3_plain) if fused else (C.conv3x3, C.conv3x3_plain)
    do = torch.randn(2, 8, 8, 48, device=cuda_device)
    before = C.conv3x3_kernel.launches
    got = torch.autograd.grad(fn(*inputs), inputs, do)
    assert C.conv3x3_kernel.launches == before + 1
    want = torch.autograd.grad(plain(*inputs), inputs, do)
    for g, w in zip(got, want):
        assert _relerr(g, w) < TOL_FP32


# ---------------------------------------------------------------------------
# K7: int8 matmul
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1000, 48, 36), (4096, 320, 960), (300, 64, 128), (256, 80, 64),
                                   (129, 1280, 132)])
def test_int8_matmul_exact_on_card(cuda_device, m, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    xq = torch.randint(-128, 128, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
    wq = torch.randint(-128, 128, (k, n), generator=g, device=cuda_device, dtype=torch.int8)
    before = I8.int8_matmul.launches
    got = I8.int8_matmul(xq, wq)
    assert I8.int8_matmul.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, I8.int8_matmul_plain(xq, wq))
    assert torch.equal(got.cpu(), xq.cpu().int() @ wq.cpu().int())


@pytest.mark.gpu
def test_int8_matmul_refuses_unaligned(cuda_device):
    xq = torch.zeros(64, 20, device=cuda_device, dtype=torch.int8)
    wq = torch.zeros(20, 64, device=cuda_device, dtype=torch.int8)
    before = I8.int8_matmul.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        I8.int8_matmul(xq, wq)
    assert I8.int8_matmul.launches == before


@pytest.mark.gpu
def test_int8_pallas_close_to_bf16_product_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2048, 320, generator=g, device=cuda_device).to(torch.bfloat16)
    wf = torch.randn(320, 640, generator=g, device=cuda_device) / 320 ** 0.5
    wq, ws = I8.quantize_weight(wf)
    got = I8.int8_pallas(x, wq, ws).float()
    want = x.float() @ wf
    assert got.dtype == torch.float32 and _relerr(got, want) < 5e-2
    assert torch.equal(I8.int8_pallas(x, wq, ws), I8.int8_library(x, wq, ws))


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1000, 48, 36), (4096, 2880, 320), (129, 1280, 132), (2048, 11520, 1280)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_dequant_on_card(cuda_device, m, k, n, out_dtype):
    """K7 on K-major weights (as the int8 downsamplers store them), int32
    and dequantised: equal to the plain versions (the epilogue repeats the
    plain dequantisation's fp32 operations in order)."""
    g = torch.Generator(device=cuda_device).manual_seed(m + 3 * k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda_device, dtype=torch.int8).t()
    xs = torch.rand((), generator=g, device=cuda_device) * 1e-2
    ws = torch.rand(n, generator=g, device=cuda_device) * 1e-2
    bias = torch.randn(n, generator=g, device=cuda_device)
    want = I8.int8_matmul_plain(xq, wq)
    assert torch.equal(I8.int8_matmul(xq, wq), want)
    for b in (bias, None):
        got = I8.int8_matmul(xq, wq, scale=xs, col_scale=ws, bias=b, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, I8.dequantize(want, xs, ws, b, out_dtype))


# ---------------------------------------------------------------------------
# the int8 3x3 conv
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,c,co,dtype", [
    (2, 8, 8, 32, 16, torch.bfloat16),
    (2, 12, 8, 144, 264, torch.bfloat16),     # channel tail, Cout tail (n128)
    (2, 16, 16, 320, 320, torch.bfloat16),    # n160
    (1, 6, 300, 64, 136, torch.bfloat16),     # strips of a wide image
    (2, 64, 64, 320, 640, torch.bfloat16),    # n256, several images per CTA row
    (3, 5, 7, 48, 24, torch.float32),
])
def test_int8_conv_kernel_exact_on_card(cuda_device, b, h, w, c, co, dtype):
    from i2v_adapter_tpu_torch.ops import int8 as Q

    g = torch.Generator(device=cuda_device).manual_seed(b * h * w + c + co)
    x = (torch.randn(b, h, w, c, generator=g, device=cuda_device) * 3).to(dtype)
    kernel = torch.randn(3, 3, c, co, generator=g, device=cuda_device) / (9 * c) ** 0.5
    bias = torch.randn(co, generator=g, device=cuda_device)
    wq, ws = Q.quantize_weight(kernel)
    xs = Q.activation_scale(x)
    want = Q.int8_conv_int32_plain(Q.quantize_activation(x, xs), wq)
    before = Q.int8_conv3x3_kernel.launches
    got = Q.int8_conv3x3_kernel(x, wq, xs, ws, bias, out_dtype=torch.int32)
    assert Q.int8_conv3x3_kernel.launches == before + 1
    assert torch.equal(got, want)
    got = Q.int8_conv3x3_kernel(x, wq, xs, ws, bias)
    assert got.dtype == dtype and torch.equal(got, Q.dequantize(want, xs, ws, bias, dtype))
    # the whole op, with its quantisers, against the plain version
    assert torch.equal(Q.int8_conv(x, kernel, bias), Q.int8_conv_plain(x, kernel, bias))


@pytest.mark.gpu
@pytest.mark.parametrize("padding", [1, 0])
def test_int8_strided_conv_through_k7_on_card(cuda_device, padding):
    from i2v_adapter_tpu_torch.ops import int8 as Q

    g = torch.Generator(device=cuda_device).manual_seed(padding)
    x = torch.randn(4, 17, 16, 64, generator=g, device=cuda_device).to(torch.bfloat16)
    kernel = torch.randn(3, 3, 64, 96, generator=g, device=cuda_device) / 24
    bias = torch.randn(96, generator=g, device=cuda_device)
    before = (I8.int8_matmul.launches, Q.int8_conv3x3_kernel.launches)
    got = Q.int8_conv(x, kernel, bias, stride=2, padding=padding)
    assert (I8.int8_matmul.launches, Q.int8_conv3x3_kernel.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, Q.int8_conv_plain(x, kernel, bias, stride=2, padding=padding))


@pytest.mark.gpu
def test_int8_conv_kernel_refuses_unaligned_channels(cuda_device):
    from i2v_adapter_tpu_torch.ops import int8 as Q

    x = torch.zeros(1, 4, 4, 24, device=cuda_device, dtype=torch.bfloat16)
    wq = torch.zeros(16, 3, 3, 24, device=cuda_device, dtype=torch.int8)
    one = torch.ones((), device=cuda_device)
    before = Q.int8_conv3x3_kernel.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.int8_conv3x3_kernel(x, wq, one, torch.ones(16, device=cuda_device), None)
    assert Q.int8_conv3x3_kernel.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("c,co,dtype,view", [(320, 320, torch.bfloat16, True), (2560, 1280, torch.bfloat16, True),
                                             (144, 264, torch.float32, True), (48, 24, torch.float32, False)])
def test_quantize_weight_kernel_equals_plain_on_card(cuda_device, c, co, dtype, view):
    """The weight quantiser on an OIHW parameter's HWIO view (as the models
    pass it) or on an HWIO-contiguous array: int8 weights and scales equal
    to the plain version's."""
    from i2v_adapter_tpu_torch.ops import int8 as Q

    g = torch.Generator(device=cuda_device).manual_seed(c + co)
    if view:
        kernel = (torch.randn(co, c, 3, 3, generator=g, device=cuda_device) / (9 * c) ** 0.5).to(dtype)
        kernel = kernel.permute(2, 3, 1, 0)
    else:
        kernel = (torch.randn(3, 3, c, co, generator=g, device=cuda_device) / (9 * c) ** 0.5).to(dtype)
    before = Q.quantize_weights.launches
    wq, ws = Q.quantize_weight(kernel)
    assert Q.quantize_weights.launches == before + 1
    pq, ps = Q.quantize_weight_plain(kernel)
    assert wq.dtype == torch.int8 and wq.shape == (co, 3, 3, c) and ws.dtype == torch.float32
    assert torch.equal(wq, pq) and torch.equal(ws, ps)


@pytest.mark.gpu
def test_grouped_quantiser_equals_plain_on_card(cuda_device):
    """Sites of several widths and both dtypes in one grouped launch, rows
    read 16 bytes at a time and (C = 20 in bf16: 360-byte rows) one by one:
    each site's int8 weights and scales equal to the plain version's."""
    from i2v_adapter_tpu_torch.ops import int8 as Q

    g = torch.Generator(device=cuda_device).manual_seed(7)
    shapes = [(320, 320, torch.bfloat16), (2560, 1280, torch.bfloat16), (136, 264, torch.bfloat16),
              (20, 16, torch.bfloat16), (24, 40, torch.float32), (640, 320, torch.float32)]
    kernels = [(torch.randn(co, c, 3, 3, generator=g, device=cuda_device) / (9 * c) ** 0.5).to(dt)
               .permute(2, 3, 1, 0) for c, co, dt in shapes]
    before = Q.quantize_weights.launches
    got = Q.quantize_weights(kernels)
    assert Q.quantize_weights.launches == before + 1
    for k, (wq, ws) in zip(kernels, got):
        pq, ps = Q.quantize_weight_plain(k)
        assert torch.equal(wq, pq) and torch.equal(ws, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("encoder_cache", [1, 2])
def test_scan_dispatch_equals_stepwise_on_card(cuda_device, encoder_cache):
    """A tiny fp32 pipeline at the serving default (K1, K2, the int8 conv
    kernel and K7 inside the graphs): 'scan' captures each step kind used
    twice or more once and replays it, equal bit for bit to 'stepwise', the
    launch counts equal; a repeated call replays the kept graphs with no
    capture."""
    import numpy as np

    from i2v_adapter_tpu_torch.config import PipelineConfig, tiny_test_config
    from i2v_adapter_tpu_torch.ops import launches
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    pc = PipelineConfig(num_frames=2, height=32, width=32, num_inference_steps=7, blur_sigma=1.0,
                        dtype="float32")
    pipe = random_pipeline(tiny_test_config(), pc, cuda_device, seed=2)
    image = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    outs, counts = {}, {}
    for dispatch in ("stepwise", "scan"):
        before = launches.snapshot()
        outs[dispatch] = pipe("a cat", condition_image=image, seed=1, output_type="latent", dispatch=dispatch,
                              encoder_cache=encoder_cache)
        counts[dispatch] = launches.since(before)
    assert pipe.last_dispatch["dispatch"] == "scan"
    assert len(pipe.last_dispatch["capture_ms"]) == encoder_cache  # one graph per kind used twice or more
    assert counts["scan"] == counts["stepwise"] and counts["scan"]["int8_conv3x3_kernel"] > 0
    np.testing.assert_array_equal(outs["scan"], outs["stepwise"])
    # again: the kept graphs replay with no capture, the same clip and launches
    before = launches.snapshot()
    again = pipe("a cat", condition_image=image, seed=1, output_type="latent", dispatch="scan",
                 encoder_cache=encoder_cache)
    assert pipe.last_dispatch["graph_cache"]["hit"] and pipe.last_dispatch["capture_ms"] == []
    assert launches.since(before) == counts["scan"]
    np.testing.assert_array_equal(again, outs["stepwise"])


@pytest.mark.gpu
def test_native_preprocessing_builds_on_card_host(cuda_device):
    """The host library the WebVid path uses (``csrc/preprocess.cpp``,
    built with g++ at first use) loads, and its [-1, 1] resize and crop
    agrees with the numpy path."""
    import numpy as np

    from i2v_adapter_tpu_torch.data import native
    from i2v_adapter_tpu_torch.utils.image import resize_center_crop

    assert native.available(), native.library_path()
    frames = np.random.default_rng(0).integers(0, 256, (3, 40, 60, 3), dtype=np.uint8)
    got = native.preprocess_frames_pm1(frames, 32)
    want = np.stack([resize_center_crop(f.astype(np.float32) / 255.0, 32, 32) * 2 - 1 for f in frames])
    np.testing.assert_allclose(got, want, atol=2e-3)


def _port_synth():
    """``tests/torch_port_synth.py`` by path (a package named ``tests`` may
    be installed on the card machine)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_port_synth.py")
    spec = importlib.util.spec_from_file_location("torch_port_synth", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
def test_tiny_driver_run_on_card(cuda_device, tmp_path):
    """``training/driver.py`` at the tiny config on the card, 256 px (so
    the level-0 sites hold 1024 tokens), bf16, remat: 2 steps launch K1, K2
    and K3 and no int8 kernel, and write the full states, the epoch's
    adapter checkpoint and the pipeline export."""
    import os

    import numpy as np

    from i2v_adapter_tpu_torch.config import tiny_test_config
    from i2v_adapter_tpu_torch.ops import launches
    from i2v_adapter_tpu_torch.training import driver

    cv2 = pytest.importorskip("cv2")
    cfg = tiny_test_config()
    _port_synth().write_pretrained_dir(str(tmp_path / "pre"), cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    (tmp_path / "videos" / "p0").mkdir(parents=True)
    rows = []
    for i in range(2):
        w = cv2.VideoWriter(str(tmp_path / "videos" / "p0" / f"v{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8,
                            (272, 256))
        if not w.isOpened():
            pytest.skip("no mp4 writer")
        for _ in range(16):
            w.write(rng.integers(0, 256, (256, 272, 3), dtype=np.uint8))
        w.release()
        rows.append(f"v{i},clip {i},p0")
    (tmp_path / "train.csv").write_text("videoid,name,page_dir\n" + "\n".join(rows) + "\n")
    argv = ["--task_name", "t", "--pretrained_model_path", str(tmp_path / "pre"), "--csv_path",
            str(tmp_path / "train.csv"), "--video_folder", str(tmp_path / "videos"), "--output_dir",
            str(tmp_path / "out"), "--resolution", "256", "--n_frames", "4", "--train_batch_size", "2",
            "--gradient_accumulation_steps", "1", "--mixed_precision", "bfloat16", "--freeze_dtype", "bfloat16",
            "--gradient_checkpointing", "--max_train_steps", "2", "--num_train_epochs", "2",
            "--checkpoint_epoch", "1", "--checkpointing_steps", "1", "--num_workers", "1", "--report_to", "none"]
    before = launches.snapshot()
    result = driver.main(argv, model_config=cfg)
    counts = launches.since(before)
    assert result["global_step"] == 2 and all(np.isfinite(result["losses"]))
    assert min(counts["flash_attention"], counts["temporal_attention_cs"], counts["flash_attention_bwd"]) > 0
    assert counts["int8_conv3x3_kernel"] == counts["int8_matmul"] == 0
    task = tmp_path / "out" / "t"
    for path in ("state/step_1.safetensors", "state/step_2.safetensors",
                 "epoch_1/i2v_adapter/diffusion_pytorch_model.safetensors",
                 "epoch_2/i2v_adapter/diffusion_pytorch_model.safetensors",
                 "pipeline/unet/flax_model.safetensors", "pipeline/model_config.json"):
        assert os.path.exists(task / path), path


# ---------------------------------------------------------------------------
# the GroupNorm kernel (csrc/group_norm.cu) against the composition
# ---------------------------------------------------------------------------

# (samples, positions, channels, eps) of every GroupNorm site of a 512 px and
# a 256 px CFG evaluation (32 frame-evals; the resnets' norm1 inputs with the
# up blocks' concatenated skips, eps 1e-5; the transformers' norms, 1e-6),
# the motion norm over (F, H, W) per clip (2 clips, 1e-6), and the VAE
# decoder's at 2 frames (512 and 256 px, 1e-6)
GN_SITES = sorted({
    *[(32, h * h, c, 1e-5) for h, cs in ((64, (320, 960, 640)), (32, (320, 640, 1920, 1280, 960)),
                                         (16, (320, 640, 1280, 2560, 1920, 960)), (8, (640, 1280, 2560, 1920)),
                                         (4, (1280, 2560))) for c in cs],
    *[(32, h * h, c, 1e-6) for h, c in ((64, 320), (32, 640), (16, 1280), (32, 320), (16, 640), (8, 1280))],
    *[(2, 16 * h * h, c, 1e-6) for h, c in ((64, 320), (32, 640), (16, 1280), (8, 1280), (32, 320),
                                           (16, 640), (4, 1280))],
    *[(2, h * h, c, 1e-6) for h, c in ((64, 512), (128, 512), (256, 512), (256, 256), (512, 256), (512, 128),
                                       (32, 512), (128, 256), (256, 128))],
})


def _gn_operands(dev, n, rows, c, dtype, seed):
    """Activations with a per-channel offset and spread, bf16-stored (or
    fp32) affine parameters."""
    g = torch.Generator(device=dev).manual_seed(seed)
    spread = 0.5 + 2 * torch.rand(c, generator=g, device=dev)
    x = torch.randn(n, rows, c, generator=g, device=dev) * spread + torch.randn(c, generator=g, device=dev)
    w = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    b = 0.2 * torch.randn(c, generator=g, device=dev)
    return x.to(dtype), w.to(dtype), b.to(dtype)


def _gn_close(got, want) -> bool:
    """bf16: within 2 ulps of each value, an ulp taken at least at 2^-12 of
    max |want| (a value near 0 differs by the statistics' fp32 rounding,
    which is absolute); fp32: within 4e-6 of max |want| (that rounding:
    summation orders over up to 10^6 values per group)."""
    fp32 = want.dtype == torch.float32
    got, want = got.float(), want.float()
    peak = float(want.abs().max())
    if fp32:
        return float((got - want).abs().max()) <= 4e-6 * peak
    mag = torch.clamp_min(want.abs(), peak * 2.0 ** -12)
    return bool(((got - want).abs() <= 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7)).all())


# fp32 at the widths whose rows fit one CTA (C <= 2048; the rule sends
# 2560 fp32 channels to the composition)
GN_CASES = [(*site, dtype) for dtype in (torch.bfloat16, torch.float32) for site in GN_SITES
            if dtype == torch.bfloat16 or site[2] <= 2048]


def _check_gn_case(dev, n, rows, c, groups, eps, dtype, silu):
    """The kernel's plain apply against ``group_norm_plain`` on the same
    inputs; its SiLU equal bit for bit to ``F.silu`` of its own plain output
    (the statistics are the same in every launch); its abs-max equal to
    max |out|, so the int8 scale is ``activation_scale``'s bit for bit."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.ops import int8 as Q
    from i2v_adapter_tpu_torch.ops import norms as N

    x, w, b = _gn_operands(dev, n, rows, c, dtype, seed=n + rows + c + groups)
    before = N.group_norm_fused.launches
    got = N.group_norm_fused(x, groups, eps, w, b)
    assert N.group_norm_fused.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    if not silu:
        assert _gn_close(got, N.group_norm_plain(x, groups, eps, w, b))
        out, peak = N.group_norm_fused(x, groups, eps, w, b, absmax=True)
    else:
        out, peak = N.group_norm_fused(x, groups, eps, w, b, silu=True, absmax=True)
        assert torch.equal(out, F.silu(got))
    assert peak.dtype == torch.float32 and peak.ndim == 0
    assert torch.equal(peak, out.float().abs().amax())
    assert torch.equal(Q.absmax_scale(peak), Q.activation_scale(out))


@pytest.mark.gpu
@pytest.mark.parametrize("silu", [False, True], ids=["apply", "silu_absmax"])
@pytest.mark.parametrize("n,rows,c,eps,dtype", GN_CASES, ids=lambda v: str(v))
def test_group_norm_kernel_matches_composition_on_card(cuda_device, n, rows, c, eps, dtype, silu):
    """Every site of the video UNet and the VAE decoder, 32 groups
    (``_check_gn_case``)."""
    _check_gn_case(cuda_device, n, rows, c, 32, eps, dtype, silu)


# (samples, positions, channels) of the latent zoo's samplers (CFG-doubled
# 32x32 latents: SimpleUNet's levels with the up path's concatenated inputs,
# SimpleUNet3D's 16 frames and its time stack over (F, H, W) per clip; its
# norms take 8 groups) and of the dome (8 images of 64x64; 1 group)
GN_OTHER_SITES = [(2, 1024, 64), (2, 1024, 192), (2, 256, 384), (2, 64, 512), (32, 1024, 64), (32, 256, 128),
                  (32, 64, 256), (2, 16 * 1024, 64), (2, 16 * 64, 256), (8, 4096, 64), (8, 1024, 128),
                  (8, 256, 256), (8, 64, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("silu", [False, True], ids=["apply", "silu_absmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("groups", [1, 8, 32])
@pytest.mark.parametrize("n,rows,c", GN_OTHER_SITES, ids=lambda v: str(v))
def test_group_norm_kernel_matches_composition_at_other_groups_on_card(cuda_device, n, rows, c, groups, dtype,
                                                                        silu):
    """The zoo's and the dome's sites with 1, 8 and 32 groups, fp32 (as they
    run) and bf16 (``_check_gn_case``)."""
    _check_gn_case(cuda_device, n, rows, c, groups, 1e-6, dtype, silu)


@pytest.mark.gpu
def test_group_norm_kernel_refuses_what_the_rule_refuses_on_card(cuda_device):
    """2560 fp32 channels (640 vectors a row, over one CTA) and an odd
    channel count: the wrapper raises, the models' GroupNorm keeps the
    composition with no launch."""
    from i2v_adapter_tpu_torch.models import layers
    from i2v_adapter_tpu_torch.ops import norms as N

    for c, groups, dtype in ((2560, 32, torch.float32), (20, 4, torch.bfloat16)):
        x, w, b = _gn_operands(cuda_device, 2, 64, c, dtype, seed=c)
        before = N.group_norm_fused.launches
        with pytest.raises(ValueError, match="channels"):
            N.group_norm_fused(x, groups, 1e-5, w, b)
        with torch.inference_mode():
            got = layers.group_norm(x, groups, 1e-5, w, b, silu=True)
        assert N.group_norm_fused.launches == before
        assert torch.equal(got, N.group_norm_plain(x, groups, 1e-5, w, b, True))


@pytest.mark.gpu
def test_group_norm_kernel_copies_strided_and_unaligned_inputs_on_card(cuda_device):
    """A strided x (every second position) and a contiguous x one element
    past an aligned base: the wrapper copies each and launches once, equal
    bit for bit to the kernel on a contiguous copy."""
    from i2v_adapter_tpu_torch.ops import norms as N

    x, w, b = _gn_operands(cuda_device, 2, 128, 320, torch.bfloat16, seed=5)
    wide = torch.zeros(2, 128, 2, 320, dtype=x.dtype, device=cuda_device)
    wide[:, :, 0] = x
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    flat[1:] = x.reshape(-1)
    for view in (wide[:, :, 0], flat[1:].view(x.shape)):
        assert not view.is_contiguous() or view.data_ptr() % 16
        before = N.group_norm_fused.launches
        got, peak = N.group_norm_fused(view, 32, 1e-5, w, b, silu=True, absmax=True)
        assert N.group_norm_fused.launches == before + 1
        want, want_peak = N.group_norm_fused(x, 32, 1e-5, w, b, silu=True, absmax=True)
        assert torch.equal(got, want) and torch.equal(peak, want_peak)


@pytest.mark.gpu
def test_group_norm_kernel_replays_in_a_cuda_graph_on_card(cuda_device):
    """Captured once (``ops.launches.capture``: counted at replays, not at
    capture) and replayed on new inputs: each replay equals an eager call on
    the same input bit for bit, abs-max included -- the second input's
    far smaller abs-max shows the slot is zeroed inside the graph."""
    from i2v_adapter_tpu_torch.ops import launches
    from i2v_adapter_tpu_torch.ops import norms as N

    x0, w, b = _gn_operands(cuda_device, 32, 256, 640, torch.bfloat16, seed=1)
    x1 = torch.zeros_like(x0)  # every group constant: out = silu(beta), far under x0's abs-max
    static, outs = x0.clone(), {}

    def body():
        outs["y"], outs["peak"] = N.group_norm_fused(static, 32, 1e-5, w, b, silu=True, absmax=True)

    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        body()
        torch.cuda.synchronize(cuda_device)
        before = launches.snapshot()["group_norm_fused"]
        graph, counts = launches.capture(body)
        assert counts["group_norm_fused"] == 1 and launches.snapshot()["group_norm_fused"] == before
        peaks = []
        for x in (x0, x1):
            static.copy_(x)
            launches.replay(graph, counts)
            want, want_peak = N.group_norm_fused(x, 32, 1e-5, w, b, silu=True, absmax=True)
            torch.cuda.synchronize(cuda_device)
            assert torch.equal(outs["y"], want) and torch.equal(outs["peak"], want_peak)
            peaks.append(float(outs["peak"]))
        assert launches.snapshot()["group_norm_fused"] == before + 4
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    assert peaks[1] < peaks[0]
    del graph


@pytest.mark.gpu
def test_group_norm_dispatch_on_card(cuda_device):
    """``models.layers.group_norm`` on the card: the composition wherever
    autograd records (output bit for bit, the gradient flows, no launch),
    the kernel where it does not (grad mode off, inference mode, or nothing
    requires a gradient)."""
    from i2v_adapter_tpu_torch.models import layers
    from i2v_adapter_tpu_torch.ops import norms as N

    x, w, b = _gn_operands(cuda_device, 4, 64, 320, torch.bfloat16, seed=3)
    before = N.group_norm_fused.launches
    xg = x.clone().requires_grad_(True)
    y = layers.group_norm(xg, 32, 1e-5, w, b, silu=True)
    assert N.group_norm_fused.launches == before and y.requires_grad
    assert torch.equal(y, N.group_norm_plain(x, 32, 1e-5, w, b, True))
    y.float().sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    wg = w.clone().requires_grad_(True)
    layers.group_norm(x, 32, 1e-5, wg, b)
    assert N.group_norm_fused.launches == before
    with torch.no_grad():
        a = layers.group_norm(xg, 32, 1e-5, w, b, silu=True)
    with torch.inference_mode():
        c = layers.group_norm(x, 32, 1e-5, w, b, silu=True)
    d = layers.group_norm(x, 32, 1e-5, w, b, silu=True)
    assert N.group_norm_fused.launches == before + 3
    assert torch.equal(a, c) and torch.equal(a, d) and not d.requires_grad


@pytest.mark.gpu
def test_group_norm_kernel_at_every_unet_site_on_card(cuda_device):
    """One int8 evaluation of the tiny video UNet in bf16 under inference
    mode runs the kernel once per GroupNorm module; at every site, on the
    activations the UNet gives it, the kernel's apply is within 2 bf16 ulps
    of the composition, and what the site received (with SiLU where a conv
    follows) is ``F.silu`` of that apply bit for bit."""
    import torch.nn.functional as F

    from i2v_adapter_tpu_torch.config import tiny_test_config
    from i2v_adapter_tpu_torch.models import layers
    from i2v_adapter_tpu_torch.ops import launches
    from i2v_adapter_tpu_torch.ops import norms as N
    from i2v_adapter_tpu_torch.ops import trace_unet

    unet, evaluate = trace_unet.build(tiny_test_config(), cuda_device, True, 4, 64)
    norms = [m for m in unet.modules() if isinstance(m, layers.GroupNorm)]
    evaluate()
    before = launches.snapshot()
    evaluate()
    assert launches.since(before)["group_norm_fused"] == len(norms) > 0
    checked = []

    def check(mod, args, kwargs, out):
        x, silu = args[0], kwargs.get("silu", False)
        got = out[0] if kwargs.get("absmax", False) else out
        apply = N.group_norm_fused(x, mod.num_groups, mod.eps, mod.weight, mod.bias)
        assert _gn_close(apply, N.group_norm_plain(x, mod.num_groups, mod.eps, mod.weight, mod.bias))
        assert torch.equal(got, F.silu(apply) if silu else apply)
        checked.append(silu)

    handles = [m.register_forward_hook(check, with_kwargs=True) for m in norms]
    try:
        evaluate()
    finally:
        for h in handles:
            h.remove()
    assert len(checked) == len(norms) and any(checked) and not all(checked)
