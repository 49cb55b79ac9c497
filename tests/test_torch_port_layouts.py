"""PyTorch port vs the JAX package: the kernels that differ from K1 and K2
only in memory layout, and the int8 matmul, on the CPU, fp32 / exact.

* K5: JAX ``flash_attention(transposed_io=False, interpret=True)`` (the
  row-major Pallas kernel) vs the port's ``transposed_io=False`` entry on
  operands stored ``(B, H, N, D)``: rtol 2e-4 / atol 2e-5;
* K6: JAX ``_temporal_flash(interpret=True)`` (the all-of-C kernel), with
  Fq < F and S < 128, vs ``temporal_attention(impl="kernel")``: the same;
* K7: the port's plain int32 product vs ``jax.lax.dot_general`` with an
  int32 result on the same int8 arrays, equal; ``int8_pallas`` vs the
  reference's ``int8_dot`` within one quantisation step of the output.

On the CPU the port's wrappers take their plain versions and count no
launch; the card tests hold the CUDA kernels against the same plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.ops import attention as jattn
from i2v_adapter_tpu.ops import profile_int8_dense as jint8
from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.ops import profile_int8_dense as I8
from tests.torch_port_common import one_torch_thread  # noqa: F401

T = torch.from_numpy


@pytest.mark.parametrize("rep,nq,d", [(1, 64, 16), (3, 40, 8), (2, 130, 40)])
def test_row_major_flash_matches_pallas_interpret(rep, nq, d):
    rng = np.random.default_rng(nq + d)
    bkv, h = 2, 2
    q = rng.standard_normal((bkv * rep, nq, h, d)).astype(np.float32)
    k = rng.standard_normal((bkv, nq, h, d)).astype(np.float32)
    v = rng.standard_normal((bkv, nq, h, d)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_repeat=rep,
                                 transposed_io=False, interpret=True)
    # (B, H, N, D) storage handed over as (B, N, H, D) views
    qr, kr, vr = (T(np.ascontiguousarray(t.transpose(0, 2, 1, 3))).transpose(1, 2) for t in (q, k, v))
    assert not qr.is_contiguous() and qr.transpose(1, 2).is_contiguous()
    A.reset_launch_counts()
    got = A.flash_attention(qr, kr, vr, kv_repeat=rep, transposed_io=False)
    assert A.launch_counts()["flash_attention"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    # operands in the default layout are relaid, not refused
    same = A.flash_attention(T(q), T(k), T(v), kv_repeat=rep, transposed_io=False)
    np.testing.assert_allclose(same.numpy(), got.numpy(), rtol=1e-6, atol=1e-6)


def test_row_major_helper_makes_no_copy_of_row_major_storage():
    t = torch.randn(2, 3, 5, 4).transpose(1, 2)  # (B, N, H, D) view of (B, H, N, D)
    assert A._row_major(t).data_ptr() == t.data_ptr()
    c = torch.randn(2, 5, 3, 4)
    r = A._row_major(c)
    assert r.data_ptr() != c.data_ptr() and r.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(r, c)


@pytest.mark.parametrize("fq,f,s,c,heads", [(4, 4, 8, 16, 2), (2, 4, 8, 16, 2), (8, 8, 64, 32, 4),
                                            (3, 6, 24, 16, 1)])
def test_forced_temporal_kernel_matches_pallas_interpret(fq, f, s, c, heads):
    """S < 128 everywhere: 'auto' takes the einsum, impl="kernel" the
    wrapper (its plain version on the CPU); both match the Pallas kernel."""
    rng = np.random.default_rng(fq + f + s)
    k = rng.standard_normal((2, f, s, c)).astype(np.float32)
    v = rng.standard_normal((2, f, s, c)).astype(np.float32)
    q = rng.standard_normal((2, fq, s, c)).astype(np.float32)
    want = jattn._temporal_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads,
                                 interpret=True)
    calls = []
    real = A.temporal_attention_cs
    try:
        A.temporal_attention_cs = lambda *a: (calls.append(1), real(*a))[1]
        auto = A.temporal_attention(T(q), T(k), T(v), heads=heads)
        assert calls == []
        got = A.temporal_attention(T(q), T(k), T(v), heads=heads, impl="kernel")
        assert calls == [1]
    finally:
        A.temporal_attention_cs = real
    assert got.shape == (2, fq, s, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(auto.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("m,k,n", [(37, 48, 20), (128, 320, 64), (5, 16, 4)])
def test_int8_plain_product_equals_jax_dot_general(m, k, n):
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-128, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-128, 128, (k, n), dtype=np.int8)
    want = jax.lax.dot_general(jnp.asarray(xq), jnp.asarray(wq), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    before = I8.int8_matmul.launches
    got = I8.int8_matmul(T(xq), T(wq))
    assert I8.int8_matmul.launches == before and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(I8.int8_matmul_plain(T(xq), T(wq)).numpy(), np.asarray(want))


def test_int8_pallas_matches_reference_int8_dot():
    """The composite (dynamic per-tensor activation scale, int8 product,
    per-column dequantisation, bf16 result) vs the reference's ``int8_dot``:
    a result may land on the neighbouring bf16 value (fp32 rounding of the
    scales), never further."""
    rng = np.random.default_rng(0)
    m, k, n = 64, 96, 48
    x = rng.standard_normal((m, k)).astype(np.float32)
    wf = (rng.standard_normal((k, n)) / k ** 0.5).astype(np.float32)
    wq, ws = I8.quantize_weight(T(wf))
    jws = jnp.max(jnp.abs(jnp.asarray(wf)), axis=0) / 127.0
    jwq = jnp.round(jnp.asarray(wf) / jws).astype(jnp.int8)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jint8.int8_dot(xb, jwq, jws).astype(jnp.float32))
    got = I8.int8_pallas(T(x).to(torch.bfloat16), wq, ws)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    step = np.abs(want) * 2.0 ** -7 + 1e-6  # one bf16 spacing
    assert np.all(np.abs(got - want) <= step)
    ref = np.asarray(xb.astype(jnp.float32)) @ wf
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 5e-2


def test_int8_matmul_checks_operands():
    with pytest.raises(TypeError, match="int8"):
        I8.int8_matmul(torch.zeros(4, 16), torch.zeros(16, 4, dtype=torch.int8))
    with pytest.raises(ValueError, match="shapes"):
        I8.int8_matmul(torch.zeros(4, 16, dtype=torch.int8), torch.zeros(8, 4, dtype=torch.int8))


def test_int8_tool_runs_on_cpu(capsys):
    assert I8.main(["--device", "cpu", "--shapes", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("cpu") and '"exact": true' in out[1]
    assert len(I8.SHAPES) == len(jint8.SHAPES) and list(I8.SHAPES) == list(jint8.SHAPES)
