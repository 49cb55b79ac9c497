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
    return torch.device("cuda", 0)


def _relerr(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("rep,n,d,static_max", [(1, 1024, 80, 64.0), (16, 577, 40, 0.0)])
def test_flash_kernel_matches_plain_on_card(cuda_device, rep, n, d, static_max):
    """fp32: the scalar kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(16, n, 4, d, generator=g, device=cuda_device)
    k = torch.randn(16 // rep, n, 4, d, generator=g, device=cuda_device)
    v = torch.randn(16 // rep, n, 4, d, generator=g, device=cuda_device)
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kv_repeat=rep, static_max=static_max)
    assert A.flash_attention.launches == before + 1
    want = A._plain_attention(q, k, v, rep, 1 / math.sqrt(d), static_max)
    assert _relerr(got, want) < TOL_FP32


@pytest.mark.gpu
@pytest.mark.parametrize("rep", [1, 16])
@pytest.mark.parametrize("static_max", [64.0, 0.0])
def test_flash_mma_kernel_matches_plain_on_card(cuda_device, rep, static_max):
    """bf16: the tensor-core kernel at a main-path shape (32 frame-evals,
    N = 1024, 8 heads, D = 80), q a strided view of a wider buffer."""
    n, h, d = 1024, 8, 80
    g = torch.Generator(device=cuda_device).manual_seed(rep)
    q = torch.randn(32, n, 2 * h * d, generator=g, device=cuda_device)[..., : h * d]
    q = q.unflatten(-1, (h, d)).to(torch.bfloat16)
    k = torch.randn(32 // rep, n, h, d, generator=g, device=cuda_device).to(torch.bfloat16)
    v = torch.randn(32 // rep, n, h, d, generator=g, device=cuda_device).to(torch.bfloat16)
    before = A.flash_attention.launches
    got = A.flash_attention(q, k, v, kv_repeat=rep, static_max=static_max)
    assert A.flash_attention.launches == before + 1
    want = A._plain_attention(q, k, v, rep, 1 / math.sqrt(d), static_max)
    assert torch.isfinite(got).all()
    assert _relerr(got, want) < TOL_BF16


@pytest.mark.gpu
def test_flash_kernel_refuses_unaligned_bf16(cuda_device):
    """bf16 rows the tensor-core kernel cannot read raise; nothing launches."""
    q = torch.randn(2, 256, 2, 36, device=cuda_device).to(torch.bfloat16)
    before = A.flash_attention.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        A.flash_attention(q, q, q)
    assert A.flash_attention.launches == before


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
                                     (2, 1030, 80)])
def test_flash_bwd_kernel_matches_plain_on_card(cuda_device, dtype, rep, n, d):
    """K3 vs its plain version from the same o and lse: fp32 (scalar
    kernels) and bf16 (tensor-core kernels), kv_repeat fan-in, ragged N."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static_max", [64.0, 0.0])
def test_flash_lse_matches_plain_logsumexp_on_card(cuda_device, dtype, static_max):
    """K1's log2 logsumexp vs the plain one, both from fp32 scores."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(32, 577, 8, 80, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, 577, 8, 80, generator=g, device=cuda_device).to(dtype)
    o, lse = A.flash_attention(q, k, k, kv_repeat=16, static_max=static_max, with_lse=True)
    want_o, want = A._plain_attention(q, k, k, 16, 1 / math.sqrt(80), static_max, with_lse=True)
    assert lse.shape == (32 * 8, 577) and lse.dtype == torch.float32
    assert _relerr(lse, want) < TOL_FP32
    assert _relerr(o, want_o) < (TOL_FP32 if dtype == torch.float32 else TOL_BF16)


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
