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
