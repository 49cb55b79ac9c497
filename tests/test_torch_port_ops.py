"""PyTorch port vs the JAX package: attention ops, blur and schedulers.

The JAX side runs the Pallas kernels in interpret mode; the port's wrappers
take their plain versions on CPU tensors.  fp32, tolerance 1e-5 for the ops
and 1e-6 for the scheduler maths.  The kernel-vs-plain checks on the card
are in ``test_torch_port_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.config import SchedulerConfig as JSchedulerConfig
from i2v_adapter_tpu.ops import attention as JA
from i2v_adapter_tpu.ops.blur import gaussian_blur as j_blur
from i2v_adapter_tpu.schedulers import add_noise as j_add_noise
from i2v_adapter_tpu.schedulers import ddim_step as j_ddim_step
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu.schedulers.ddim import ddim_schedule_arrays as j_arrays
from i2v_adapter_tpu_torch.config import SchedulerConfig
from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.ops.blur import gaussian_blur
from i2v_adapter_tpu_torch.schedulers import add_noise, ddim_schedule_arrays, ddim_step, make_schedule
from tests.torch_port_common import maxerr, one_torch_thread  # noqa: F401

TOL = 1e-5


def _qkv(rng, bq, bkv, nq, nk, h, d, scale=1.0):
    q = (rng.standard_normal((bq, nq, h, d)) * scale).astype(np.float32)
    k = (rng.standard_normal((bkv, nk, h, d)) * scale).astype(np.float32)
    v = rng.standard_normal((bkv, nk, h, d)).astype(np.float32)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [8, 40])
def test_flash_dispatch_vs_pallas_interpret(rep, d):
    rng = np.random.default_rng(10 * rep + d)
    q, k, v = _qkv(rng, rep, 1, 128, 128, 2, d)
    want = JA.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_repeat=rep,
        impl="pallas_interpret", static_max=0.0,
    )
    A.reset_launch_counts()
    got = A.dot_product_attention(*_t(q, k, v), kv_repeat=rep, impl="auto")
    assert A.launch_counts()["flash_attention"] == 0
    assert maxerr(got.numpy(), want) < TOL


@pytest.mark.parametrize("rep", [1, 4])
def test_flash_static_max_vs_pallas_interpret(rep):
    """static_max=64 (the serving default) agrees on bounded logits."""
    rng = np.random.default_rng(rep)
    q, k, v = _qkv(rng, rep, 1, 128, 192, 2, 40)
    want = JA.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_repeat=rep,
        impl="pallas_interpret", static_max=64.0,
    )
    got = A.flash_attention(*_t(q, k, v), kv_repeat=rep, static_max=64.0)
    assert maxerr(got.numpy(), want) < TOL


def test_flash_static_max_nan_rows_match():
    """Rows whose logits all fall below about -48 go NaN on both sides."""
    q = np.full((1, 128, 1, 8), -10.0, np.float32)
    k = np.full((1, 128, 1, 8), 10.0, np.float32)
    v = np.ones((1, 128, 1, 8), np.float32)
    want = np.asarray(JA.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="pallas_interpret", static_max=64.0,
    ))
    got = A.flash_attention(*_t(q, k, v), static_max=64.0).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
    exact = A.flash_attention(*_t(q, k, v), static_max=0.0).numpy()
    np.testing.assert_allclose(exact, 1.0, rtol=1e-6)


def test_short_kv_goes_to_plain_math():
    """nk < 128 (text / IP context) is plain math on both sides."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 4, 2, 64, 77, 2, 8)
    want = JA.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_repeat=2, impl="auto"
    )
    got = A.dot_product_attention(*_t(q, k, v), kv_repeat=2)
    assert maxerr(got.numpy(), want) < TOL
    plain = A.dot_product_attention(*_t(q, k, v), kv_repeat=2, impl="plain")
    assert maxerr(plain.numpy(), want) < TOL


def _bfsc(rng, b, f, s, c):
    return rng.standard_normal((b, f, s, c)).astype(np.float32)


@pytest.mark.parametrize("f", [4, 16])
def test_temporal_vs_pallas_cs_interpret(f):
    rng = np.random.default_rng(f)
    q, k, v = (_bfsc(rng, 2, f, 128, 32) for _ in range(3))
    want = JA.temporal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=2, impl="pallas_cs_interpret"
    )
    A.reset_launch_counts()
    got = A.temporal_attention(*_t(q, k, v), heads=2)
    assert A.launch_counts()["temporal_attention_cs"] == 0
    assert maxerr(got.numpy(), want) < TOL


def test_temporal_fewer_query_frames():
    """Fq < F (the sequence-parallel query slice)."""
    rng = np.random.default_rng(5)
    q = _bfsc(rng, 1, 4, 128, 32)
    k, v = _bfsc(rng, 1, 8, 128, 32), _bfsc(rng, 1, 8, 128, 32)
    want = JA._temporal_flash_cs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=2, interpret=True)
    got = A.temporal_attention_cs(*_t(q, k, v), heads=2)
    assert got.shape == (1, 4, 128, 32)
    assert maxerr(got.numpy(), want) < TOL


def test_temporal_short_s_goes_to_plain_math():
    rng = np.random.default_rng(6)
    q, k, v = (_bfsc(rng, 2, 8, 64, 32) for _ in range(3))
    want = JA.temporal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=4)
    got = A.temporal_attention(*_t(q, k, v), heads=4)
    assert maxerr(got.numpy(), want) < TOL


def test_kernel_wrappers_reject_bad_shapes():
    q = torch.zeros(2, 128, 2, 8)
    with pytest.raises(ValueError):
        A.flash_attention(q, q, q, kv_repeat=2)
    with pytest.raises(ValueError):
        A.temporal_attention_cs(torch.zeros(1, 8, 4, 32), torch.zeros(1, 4, 4, 32),
                                torch.zeros(1, 4, 4, 32), heads=2)


@pytest.mark.parametrize("sigma", [0.5, 1.0])
def test_gaussian_blur_matches_jax(sigma):
    x = np.random.default_rng(7).standard_normal((2, 3, 9, 7, 4)).astype(np.float32)
    want = j_blur(jnp.asarray(x), 3, sigma)
    got = gaussian_blur(torch.from_numpy(x), 3, sigma)
    assert maxerr(got.numpy(), want) < TOL


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing"])
@pytest.mark.parametrize("strength", [1.0, 0.9])
def test_ddim_schedule_arrays_equal(spacing, strength):
    ts, prev = ddim_schedule_arrays(SchedulerConfig(timestep_spacing=spacing), 25, strength)
    jts, jprev = j_arrays(JSchedulerConfig(timestep_spacing=spacing), 25, strength)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(prev, jprev)


def test_linspace_prev_timestep_quirk_kept():
    """prev = t - T // steps, not the next array timestep (reproduced)."""
    ts, prev = ddim_schedule_arrays(SchedulerConfig(), 25, 1.0)
    assert prev[0] == ts[0] - 40 and prev[0] != ts[1]


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear"])
def test_make_schedule_matches(beta_schedule):
    s = make_schedule(SchedulerConfig(beta_schedule=beta_schedule))
    j = j_make_schedule(JSchedulerConfig(beta_schedule=beta_schedule))
    np.testing.assert_array_equal(s.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod))
    assert float(s.final_alpha_cumprod) == float(j.final_alpha_cumprod)


def test_add_noise_matches():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    n = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([10, 901])
    want = j_add_noise(j_make_schedule(JSchedulerConfig()), jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    got = add_noise(make_schedule(SchedulerConfig()), torch.from_numpy(x), torch.from_numpy(n),
                    torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("t,tp", [(981, 941), (21, -19)])
def test_ddim_step_matches(eta, prediction_type, t, tp):
    rng = np.random.default_rng(9)
    x, eps, noise = (rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    jcfg = JSchedulerConfig(prediction_type=prediction_type)
    want = j_ddim_step(
        j_make_schedule(jcfg), jnp.asarray(eps), jnp.full((2,), t), jnp.full((2,), tp),
        jnp.asarray(x), eta=eta, noise=jnp.asarray(noise),
    )
    got = ddim_step(
        make_schedule(SchedulerConfig(prediction_type=prediction_type)), torch.from_numpy(eps),
        torch.full((2,), t), torch.full((2,), tp), torch.from_numpy(x), eta=eta,
        noise=torch.from_numpy(noise),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6 * max(1.0, float(np.abs(want).max())), rtol=0)
