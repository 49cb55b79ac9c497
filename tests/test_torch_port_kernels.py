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
# kv_repeat values, and ragged token counts that no tile size divides
FLASH_CASES = [(1, 1024, 1024, 80), (16, 577, 577, 40), (1, 256, 256, 160), (16, 256, 256, 160),
               (16, 1024, 1024, 40), (1, 577, 130, 40), (16, 130, 577, 80), (2, 130, 130, 160)]


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fq,f,s", [(16, 16, 1024), (8, 16, 576), (32, 32, 128)])
def test_temporal_kernel_matches_plain_on_card(cuda_device, fq, f, s, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(2, fq, s, 640, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, f, s, 640, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, f, s, 640, generator=g, device=cuda_device).to(dtype)
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
    (4, 8, 8, 320, 640),    # a 128-pixel tile spans two images
    (9, 4, 4, 64, 96),      # ... eight images, and ends inside one
    (2, 64, 64, 320, 320),  # the halo is as large as the tile
    (1, 5, 3, 8, 8),
    (1, 3, 260, 16, 16),    # so wide that a thread stages several pixel rows per step
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
