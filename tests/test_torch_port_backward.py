"""PyTorch port vs the JAX package: the gradients of the attention sites,
activation checkpointing and the sliced VAE encode, on the CPU.

The JAX side runs as its own tests run it: ``jax.grad`` / ``jax.vjp`` of
the XLA attention, and the Pallas flash backward in interpret mode.  The
port's wrappers take their plain versions on CPU tensors.  Tolerances are
the JAX tests' own (``rtol=2e-4, atol=2e-5``, tests/test_ops_attention.py)
for the attention gradients; 1e-6 where the port is compared with itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.ops import attention as JA
from i2v_adapter_tpu_torch.config import tiny_test_config
from i2v_adapter_tpu_torch.models import AutoencoderKL, VideoUNet
from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.utils.random_init import randomize_
from tests.torch_port_common import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=f"d{name} mismatch")


def _qkv(seed, bkv, rep, nq, nk, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bkv * rep, nq, h, d)).astype(np.float32)
    k = rng.standard_normal((bkv, nk, h, d)).astype(np.float32)
    v = rng.standard_normal((bkv, nk, h, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("flash_bwd", [True, False], ids=["k3", "plain_bwd"])
@pytest.mark.parametrize("rep,nq,nk", [(1, 37, 45), (16, 24, 29)])
def test_flash_attention_fn_grads_vs_jax(rep, nq, nk, flash_bwd):
    """(c) ``FlashAttentionFn`` (both backward routes, static offset on)
    vs ``jax.grad`` of ``xla_attention``: kv_repeat 1 and 16, ragged N."""
    q, k, v = _qkv(rep + nq, 2 if rep == 1 else 1, rep, nq, nk, 2, 8)
    loss = lambda f: lambda *a: jnp.sum(jnp.sin(f(*a)))
    want = jax.grad(loss(lambda a, b, c: JA.xla_attention(a, b, c, kv_repeat=rep)),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.FlashAttentionFn.apply(tq, tk, tv, rep, 1 / np.sqrt(8), 64.0, flash_bwd)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", got, want):
        _close(a.numpy(), b, name)


@pytest.mark.parametrize("rep", [1, 2])
def test_plain_flash_backward_vs_pallas_interpret(rep):
    """(d) K3's plain version vs the JAX ``_flash_backward`` in interpret
    mode, both fed the lse of the interpret-mode forward; blocks small
    enough for several q and kv blocks and both padding masks."""
    bkv, nq, nk, h, d = 1, 24, 40, 2, 8
    q, k, v = (jnp.asarray(x) for x in _qkv(7 + rep, bkv, rep, nq, nk, h, d))
    g = jnp.asarray(np.random.default_rng(11).standard_normal(q.shape).astype(np.float32))
    o, lse = JA.flash_attention(q, k, v, kv_repeat=rep, block_q=8, block_kv=16, interpret=True,
                                with_stats=True, static_max=64.0)
    want = JA._flash_backward(q, k, v, o, g, lse, kv_repeat=rep, scale=1.0 / np.sqrt(d),
                              interpret=True, block_q=8, block_kv=16)
    t = lambda x: torch.from_numpy(np.array(x))
    got = A.flash_attention_bwd(t(q), t(k), t(v), t(o), t(g), t(lse[:, :nq]), kv_repeat=rep)
    for name, a, b in zip("qkv", got, want):
        _close(a.numpy(), b, name)


def test_flash_lse_vs_pallas_interpret():
    """K1's lse (plain version) equals the interpret-mode kernel's."""
    q, k, v = _qkv(3, 2, 2, 40, 40, 2, 8)
    _, want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_repeat=2,
                                 block_q=8, block_kv=16, interpret=True, with_stats=True,
                                 static_max=64.0)
    _, got = A.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), kv_repeat=2,
                               static_max=64.0, with_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :40], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,fq", [(4, 4), (16, 16)])
def test_temporal_attention_fn_grads_vs_jax(f, fq):
    """(e) ``TemporalAttentionFn`` vs ``jax.vjp`` of ``_temporal_ref_mxu``
    (S >= 128, so the port's dispatch goes through the Function)."""
    rng = np.random.default_rng(f)
    q, k, v, g = (rng.standard_normal((2, f, 128, 32)).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(lambda a, b, c: JA._temporal_ref_mxu(a, b, c, 2), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = A.temporal_attention(tq, tk, tv, heads=2)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=RTOL, atol=ATOL)
    for name, a, b in zip("qkv", got, want):
        _close(a.numpy(), b, name)


def test_dispatch_without_grad_launches_forward_only():
    """With no gradient recorded the dispatchers take the forward wrappers
    directly (no Function, no lse): serving is unchanged."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 130, 130, 2, 8))
    with torch.no_grad():
        out = A.dot_product_attention(q, k, v, kv_repeat=2)
    assert out.grad_fn is None
    q.requires_grad_()
    out = A.dot_product_attention(q, k, v, kv_repeat=2)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"


def _unet_grads(unet, x, t, txt, img):
    out = unet(x, t, txt, img, enable_cross_frame_attn=True)
    params = [p for p in unet.parameters() if p.requires_grad]
    return [g.clone() for g in torch.autograd.grad((out * out).mean(), params)]


@pytest.mark.parametrize("min_nk", [1024, 256], ids=["plain_bwd", "k3"])
def test_remat_same_grads(monkeypatch, min_nk):
    """(f) Activation checkpointing gives the grads of the plain forward
    (fp32, CPU, 1e-6), with the flash backward on the 256-token sites when
    its threshold is lowered."""
    monkeypatch.setattr(A, "FLASH_BWD_MIN_NK", min_nk)
    cfg = tiny_test_config().unet.replace(flash_static_max=0.0)
    unet = randomize_(VideoUNet(cfg, device="cpu"), seed=3)
    g = torch.Generator().manual_seed(4)
    args = (torch.randn(2, 2, 16, 16, 4, generator=g), torch.tensor([10.0, 700.0]),
            torch.randn(2, 7, cfg.cross_attention_dim, generator=g),
            torch.randn(2, cfg.image_embed_dim, generator=g))
    want = _unet_grads(unet, *args)
    unet.config = cfg.replace(remat=True)
    got = _unet_grads(unet, *args)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_sliced_vae_encode_equals_full():
    """(h) ``encode(..., slice_size)`` equals the one-shot encode given the
    same posterior noise (and draws the same noise from a generator)."""
    vae = randomize_(AutoencoderKL(tiny_test_config().vae, device="cpu"), seed=5)
    g = torch.Generator().manual_seed(6)
    x = torch.rand(6, 32, 32, 3, generator=g) * 2 - 1
    noise = torch.randn(vae.latent_shape(x.shape), generator=g)
    with torch.no_grad():
        full = vae.encode(x, noise)
        sliced = vae.encode(x, noise, slice_size=2)
        drawn = [vae.encode(x, generator=torch.Generator().manual_seed(7), slice_size=s)
                 for s in (0, 3)]
    assert full.shape == (6, 16, 16, 4)
    torch.testing.assert_close(sliced, full, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(drawn[0], drawn[1], rtol=1e-6, atol=1e-6)
