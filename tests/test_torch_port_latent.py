"""PyTorch port vs the JAX package: the latent-diffusion zoo on the CPU.

* every block of ``models/simple/blocks.py`` (``ResBlock`` in 2-D and 3-D,
  ``image_only`` both ways, the cross-attention block), ``SimpleUNet`` and
  ``SimpleUNet3D`` at widths (8, 16) on 32x32 and 64x64 inputs (the port's
  flash path at 256 and 1024 keys), and the dome UNet: the JAX module under
  ``jax.jit`` and the port's on the same numpy weights, 1e-4 (``maxerr``);
* ``ddpm_step`` at t = 0 and t > 0, 1e-5;
* one ``make_latent_train_step`` step and a video step followed by an
  ``image_only`` step on the same parameters, on 32x32 latents with the
  flash backward's threshold at 256 keys so that it is taken, the port fed
  the JAX draws (each package's steps run once, in module fixtures):
  losses 1e-5, parameters 1e-4 after each step, AdamW's first moments to
  1e-3 of each leaf's max, and each leaf's update to 1e-2 of its largest;
* ``sample_latents`` on a 10-timestep schedule fed JAX's starting noise and
  per-step noise, 1e-4, and equal bit for bit to its eager loop
  (``_sample_latents_eager``) on the same draws; on 24 timesteps with a
  generator, the static-buffer program (replayed from a CUDA graph on the
  card) equal bit for bit to the eager loop, for both UNets;
* simple checkpoints written by each package and read by the other, bit
  for bit; the three latent datasets against the JAX ones, item for item;
* the training driver's async full-state save when the run raises after
  it: the file complete, no temporary left, the run's error propagated
  (and a failed write reported).
"""

import functools
import logging
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from i2v_adapter_tpu.data import latent as jlatent
from i2v_adapter_tpu.models import simple as jsimple
from i2v_adapter_tpu.models.simple import unet_dome as jdome
from i2v_adapter_tpu.schedulers import ddpm_step as j_ddpm_step
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu.training import train_latent as jtrain
from i2v_adapter_tpu_torch.data import latent as platent
from i2v_adapter_tpu_torch.models import simple as psimple
from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.schedulers import ddpm_step, make_schedule
from i2v_adapter_tpu_torch.training import checkpoint as pckpt
from i2v_adapter_tpu_torch.training import driver as pdriver
from i2v_adapter_tpu_torch.training import train_latent as ptrain
from i2v_adapter_tpu_torch.utils.convert import flatten_tree, load_flax_params, to_flax_tree
from tests.test_torch_port_driver import _train, env  # noqa: F401
from tests.torch_port_common import maxerr, one_torch_thread, random_params  # noqa: F401

WIDTHS, LEVELS, HEADS, CTX = (8, 16), (False, True), 2, 16
TOL = 1e-4


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port(module, params):
    """``module`` (a port module on the CPU) filled from the JAX tree."""
    return load_flax_params(module, params)


def _run(jmodule, params, *args, **kwargs):
    return np.asarray(jax.jit(lambda p, *a: jmodule.apply(p, *a, **kwargs))(params, *args))


def _t(x):
    return torch.from_numpy(np.array(x))


def _f32(tree):
    """A numpy tree's leaves as float32, as a JAX run holds them (the seeded
    trees hold float64 kernels)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_positional_emb():
    pos = np.array([0, 3, 17, 999], np.int32)
    want = np.asarray(jsimple.positional_emb(jnp.asarray(pos), 32))
    assert maxerr(psimple.positional_emb(_t(pos), 32).numpy(), want) <= 1e-5  # sin / cos of args up to 999


@pytest.mark.parametrize("image_only", [False, True])
def test_alpha_blender(rng, image_only):
    s, t = _np(rng, 2, 4, 8), _np(rng, 2, 4, 8)
    jm = jsimple.AlphaBlender()
    params = {"params": {"mix_factor": np.array([0.3], np.float32)}}
    want = _run(jm, params, s, t, image_only=image_only)
    got = _port(psimple.AlphaBlender(), params)(_t(s), _t(t), image_only)
    assert maxerr(got.detach().numpy(), want) <= 1e-6
    if image_only:
        np.testing.assert_array_equal(got.detach().numpy(), s)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_basic_transformer_block(rng, cross):
    """The cross block at 128 query tokens and 3 context tokens: its self
    attention through the flash entry (plain on the CPU), the cross
    attention through the plain math."""
    x, ctx = _np(rng, 2, 128, 16), _np(rng, 2, 3, CTX)
    jm = jsimple.BasicTransformerBlock(HEADS, use_cross=cross)
    params = random_params(jm, x, ctx if cross else None)
    want = _run(jm, params, x, ctx if cross else None)
    pm = _port(psimple.BasicTransformerBlock(16, HEADS, CTX if cross else None), params)
    with torch.no_grad():
        got = pm(_t(x), _t(ctx) if cross else None).numpy()
    assert maxerr(got, want) <= TOL


@pytest.mark.parametrize("image_only", [False, True])
def test_video_transformer(rng, image_only):
    x = _np(rng, 2 * 3, 4, 4, 16)
    jm = jsimple.VideoTransformer(HEADS)
    params = random_params(jm, x, num_frames=3)
    want = _run(jm, params, x, num_frames=3, image_only=image_only)
    with torch.no_grad():
        got = _port(psimple.VideoTransformer(16, HEADS), params)(_t(x), num_frames=3, image_only=image_only)
    assert maxerr(got.numpy(), want) <= TOL


@pytest.mark.parametrize("dims,kernel,cin,cout", [
    (2, None, 8, 12), (2, None, 12, 12), (3, None, 8, 12), (3, (3, 1, 1), 12, 12),
], ids=["2d-shortcut", "2d", "3d-shortcut", "3d-time-stack"])
def test_resblock(rng, dims, kernel, cin, cout):
    shape = (2, 4, 6, 5, cin) if dims == 3 else (2, 6, 5, cin)
    x, temb = _np(rng, *shape), _np(rng, 2, 16)
    jm = jsimple.ResBlock(cout, dims=dims, kernel=kernel)
    params = random_params(jm, x, temb)
    want = _run(jm, params, x, temb)
    pm = _port(psimple.ResBlock(cin, cout, dims=dims, kernel=kernel, temb_channels=16), params)
    with torch.no_grad():
        got = pm(_t(x), _t(temb)).numpy()
    assert got.shape == want.shape and maxerr(got, want) <= TOL


@pytest.mark.parametrize("image_only", [False, True])
def test_video_resblock(rng, image_only):
    x, temb = _np(rng, 2 * 3, 4, 4, 8), _np(rng, 6, 16)
    jm = jsimple.VideoResBlock(12)
    params = random_params(jm, x, temb, num_frames=3)
    want = _run(jm, params, x, temb, num_frames=3, image_only=image_only)
    pm = _port(psimple.VideoResBlock(8, 12, temb_channels=16), params)
    with torch.no_grad():
        got = pm(_t(x), _t(temb), num_frames=3, image_only=image_only).numpy()
    assert maxerr(got, want) <= TOL


# ---------------------------------------------------------------------------
# UNets
# ---------------------------------------------------------------------------


def _unet2d(widths=WIDTHS, levels=LEVELS):
    return jsimple.SimpleUNet(widths=widths, attention_levels=levels, heads=HEADS), \
        psimple.SimpleUNet(widths=widths, attention_levels=levels, heads=HEADS, context_dim=CTX, device="cpu")


def _unet3d(widths=WIDTHS, levels=LEVELS):
    return jsimple.SimpleUNet3D(widths=widths, attention_levels=levels, heads=HEADS), \
        psimple.SimpleUNet3D(widths=widths, attention_levels=levels, heads=HEADS, context_dim=CTX, device="cpu")


@pytest.mark.parametrize("size", [32, 64])
def test_simple_unet(rng, size):
    """32x32 puts 256 tokens, 64x64 1024 tokens on the attention level,
    which the port sends to its flash entry (K1 on the card)."""
    x, t, ctx = _np(rng, 2, size, size, 4), np.array([1, 500], np.int32), _np(rng, 2, 3, CTX)
    jm, pm = _unet2d()
    params = random_params(jm, x, t, ctx)
    want = _run(jm, params, x, t, ctx)
    A.reset_launch_counts()
    with torch.no_grad():
        got = _port(pm, params)(_t(x), _t(t), _t(ctx)).numpy()
    assert maxerr(got, want) <= TOL
    assert A.launch_counts()["flash_attention"] == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("size,image_only", [(32, False), (64, True)])
def test_simple_unet3d(rng, size, image_only):
    """256 and 1024 tokens at the attention level, for the spatial and the
    cross blocks' self-attention; ``image_only`` blends the temporal
    branches out."""
    x, t, ctx = _np(rng, 1, 3, size, size, 4), np.array([10], np.int32), _np(rng, 1, 3, CTX)
    jm, pm = _unet3d()
    params = random_params(jm, x, t, ctx)
    want = _run(jm, params, x, t, ctx, image_only=image_only)
    with torch.no_grad():
        got = _port(pm, params)(_t(x), _t(t), _t(ctx), image_only=image_only).numpy()
    assert maxerr(got, want) <= TOL


def test_unet_without_context_has_no_cross_attention(rng):
    """Built without ``context_dim`` the port has the leaves of a JAX model
    initialised without a context, and refuses one."""
    x, t = _np(rng, 1, 16, 16, 4), np.array([3], np.int32)
    jm = jsimple.SimpleUNet(widths=WIDTHS, attention_levels=LEVELS, heads=HEADS)
    params = random_params(jm, x, t)
    pm = _port(psimple.SimpleUNet(widths=WIDTHS, attention_levels=LEVELS, heads=HEADS, device="cpu"), params)
    with torch.no_grad():
        assert maxerr(pm(_t(x), _t(t)).numpy(), _run(jm, params, x, t)) <= TOL
        with pytest.raises(ValueError, match="context_dim"):
            pm(_t(x), _t(t), torch.zeros(1, 3, CTX))


def test_simple_unet_dome(rng):
    """The fixed 64x64 topology: DenseGeneral leaves in their Flax layouts,
    the exact GELU, the bilinear 2x upsampling's borders."""
    x, t = _np(rng, 1, 64, 64, 3), np.array([37], np.int32)
    jm = jdome.SimpleUNetDome()
    params = random_params(jm, x, t)
    want = _run(jm, params, x, t)
    pm = _port(psimple.SimpleUNetDome(device="cpu"), params)
    with torch.no_grad():
        got = pm(_t(x), _t(t)).numpy()
    assert maxerr(got, want) <= TOL
    # the carrier moves the DenseGeneral leaves as they are, both ways
    flat = flatten_tree(to_flax_tree(pm))
    for k, v in flatten_tree(_f32(params)["params"]).items():
        np.testing.assert_array_equal(flat[k], v)


# ---------------------------------------------------------------------------
# DDPM step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [[0, 0], [1, 999], [0, 500]], ids=["t0", "t>0", "mixed"])
def test_ddpm_step(rng, t):
    cfg = jtrain.LATENT_SCHEDULE
    out, sample, noise = _np(rng, 2, 4, 4, 3), _np(rng, 2, 4, 4, 3), _np(rng, 2, 4, 4, 3)
    t = np.asarray(t, np.int32)
    want = np.asarray(j_ddpm_step(j_make_schedule(cfg), jnp.asarray(out), jnp.asarray(t), jnp.asarray(sample),
                                  jnp.asarray(noise)))
    got = ddpm_step(make_schedule(ptrain.LATENT_SCHEDULE), _t(out), _t(t), _t(sample), _t(noise)).numpy()
    assert maxerr(got, want) <= 1e-5
    if (t == 0).all():  # no noise at t = 0
        no_noise = ddpm_step(make_schedule(ptrain.LATENT_SCHEDULE), _t(out), _t(t), _t(sample)).numpy()
        np.testing.assert_array_equal(got, no_noise)


# ---------------------------------------------------------------------------
# trainers and sampler
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=1)
def _jax_draws_jit(rng_key, shape):
    k_t, k_noise, k_drop = jax.random.split(rng_key, 3)
    return {"timesteps": jax.random.randint(k_t, (shape[0],), 0, 1000),
            "noise": jax.random.normal(k_noise, shape),
            "drop_uniform": jax.random.uniform(k_drop, (shape[0],))}


def _jax_draws(rng_key, shape):
    """The numbers the JAX ``step_fn`` draws from ``rng_key`` (one jit:
    drawn op by op they cost seconds of small compiles)."""
    return {k: np.asarray(v) for k, v in _jax_draws_jit(rng_key, tuple(shape)).items()}


def _adam(opt_state):
    """optax's ``ScaleByAdamState`` (the moments ``mu`` and ``nu``)."""
    return next(x for x in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu"))


# the trainers' widths: at (8, 16) the 8-channel level's GroupNorms hold one
# channel a group, which leaves the biases before them (conv1, temb_proj)
# with no gradient but rounding noise, and AdamW's first update of such a
# leaf, g / (|g| + eps), is then noise of the size of the learning rate
TRAIN_WIDTHS = (16, 32)
# and attention in the mid block only: these tests hold the step (draws,
# q-sample, CFG drop, loss, gradients, AdamW, the image_only lift), the UNet
# tests above every attention level, and each transformer block adds
# seconds to the JAX step's trace and compile
TRAIN_LEVELS = (False, False)
# the flash backward's threshold in the trainer tests: moved from 1024 keys
# to 256, so that 32x32 latents (256 tokens at level 1) take it
TRAIN_BWD_MIN_NK = 256
# an update element is compared where AdamW's denominator sqrt(nu_hat) is
# above this, far from eps (1e-8): below it the update is the gradients'
# rounding noise amplified, of any size up to the learning rate
UPDATE_DENOM_MIN = 1e-6


def _drop_half(u):
    """An uncond_prob that drops exactly one of the two contexts."""
    return float(np.sort(u).mean())


def _port_step(step_fn, opt, batch, draws):
    """One port step with the flash backward's threshold at
    ``TRAIN_BWD_MIN_NK`` on one torch thread (a module fixture runs before
    ``one_torch_thread``); returns ``(opt, loss, shapes of the flash
    backward's calls)``."""
    calls = []
    real_bwd = A.flash_attention_bwd

    def counted_bwd(*a, **k):
        calls.append(a[0].shape)
        return real_bwd(*a, **k)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(A, "FLASH_BWD_MIN_NK", TRAIN_BWD_MIN_NK)
            mp.setattr(A, "flash_attention_bwd", counted_bwd)
            opt, loss = step_fn(opt, batch, draws=draws)
    finally:
        torch.set_num_threads(threads)
    return opt, loss, calls


def _flat_np(tree):
    """A tree's leaves as numpy copies (the port's are views of its
    parameters, which the next step updates in place)."""
    return {k: np.array(v) for k, v in flatten_tree(tree).items()}


def _step(jax_before, jax_after, jopt, jloss, pm, port_before, popt, loss, bwd_calls):
    """What the step tests compare, as numpy."""
    return {"jax_before": _flat_np(jax_before["params"]), "jax_after": _flat_np(jax_after["params"]),
            "jax_adam": _adam(jopt), "jax_count": int(_adam(jopt).count), "jax_loss": float(jloss),
            "port_before": port_before, "port_after": _flat_np(to_flax_tree(pm)),
            "port_mu": _flat_np(to_flax_tree(pm, popt.mu)), "port_count": popt.count,
            "port_loss": float(loss), "bwd_calls": bwd_calls}


@pytest.fixture(scope="module")
def image_steps():
    """One ``make_latent_train_step`` step of each package on 32x32 latents,
    batch 2 with exactly one context dropped, the port fed JAX's draws."""
    rng = np.random.default_rng(0)
    lat, ctx = rng.uniform(-1, 1, (2, 32, 32, 4)).astype(np.float32), _np(rng, 2, 3, CTX)
    batch = {"latents": lat, "text_embeds": ctx}
    key = jax.random.PRNGKey(1)
    draws = _jax_draws(key, lat.shape)
    uncond = _drop_half(draws["drop_uniform"])
    jm, pm = _unet2d(TRAIN_WIDTHS, TRAIN_LEVELS)
    params = _f32(random_params(jm, lat[:1], np.zeros((1,), np.float32), ctx[:1]))
    _, jstep, tx = jtrain.make_latent_train_step(jm, uncond_prob=uncond)
    jparams, jopt, jloss = jstep(params, jax.jit(tx.init)(params), batch, key)

    _port(pm, params)
    init_fn, step_fn = ptrain.make_latent_train_step(pm, uncond_prob=uncond)
    before = _flat_np(to_flax_tree(pm))
    opt, loss, calls = _port_step(step_fn, init_fn(), batch, draws)
    return {"image": _step(params, jparams, jopt, jloss, pm, before, opt, loss, calls)}


@pytest.fixture(scope="module")
def video_steps():
    """A video step, then an ``image_only`` step on single frames (lifted to
    T = 1) on the same parameters and optimizer state: batch 1 of 3 frames
    of 32x32 latents, the port fed JAX's draws."""
    rng = np.random.default_rng(1)
    video = {"latents": rng.uniform(-1, 1, (1, 3, 32, 32, 4)).astype(np.float32), "text_embeds": _np(rng, 1, 3, CTX)}
    image = {"latents": rng.uniform(-1, 1, (1, 32, 32, 4)).astype(np.float32), "text_embeds": _np(rng, 1, 3, CTX)}
    kv, ki = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    dv, di = _jax_draws(kv, video["latents"].shape), _jax_draws(ki, (1, 1, 32, 32, 4))
    jm, pm = _unet3d(TRAIN_WIDTHS, TRAIN_LEVELS)
    params = _f32(random_params(jm, video["latents"][:1], np.zeros((1,), np.float32), video["text_embeds"][:1]))
    _, jstep_v, tx = jtrain.make_video_latent_train_step(jm)
    _, jstep_i, _ = jtrain.make_video_latent_train_step(jm, image_only=True)
    jp1, jopt1, jloss_v = jstep_v(params, jax.jit(tx.init)(params), video, kv)
    jp2, jopt2, jloss_i = jstep_i(jp1, jopt1, image, ki)

    _port(pm, params)
    init_v, step_v = ptrain.make_video_latent_train_step(pm)
    _, step_i = ptrain.make_video_latent_train_step(pm, image_only=True)
    before = _flat_np(to_flax_tree(pm))
    opt, loss_v, calls_v = _port_step(step_v, init_v(), video, dv)
    out = {"video": _step(params, jp1, jopt1, jloss_v, pm, before, opt, loss_v, calls_v)}
    before = out["video"]["port_after"]
    opt, loss_i, calls_i = _port_step(step_i, opt, image, di)
    out["image_only"] = _step(jp1, jp2, jopt2, jloss_i, pm, before, opt, loss_i, calls_i)
    return out


def _check_step(step):
    """The loss within 1e-5, the parameters after the step within 1e-4,
    and AdamW's first moments (a running mean of the gradients) each leaf
    within 1e-3 of its max |mu|."""
    assert step["port_count"] == step["jax_count"]
    assert abs(step["port_loss"] - step["jax_loss"]) <= 1e-5 * max(1.0, abs(step["jax_loss"]))
    want, got = step["jax_after"], step["port_after"]
    assert set(got) == set(want)
    for k in want:
        assert maxerr(got[k], want[k]) <= TOL, k
    want_mu, got_mu = flatten_tree(step["jax_adam"].mu["params"]), step["port_mu"]
    assert set(got_mu) == set(want_mu)
    for k in want_mu:
        scale = max(float(np.abs(want_mu[k]).max()), 1e-12)
        assert float(np.abs(got_mu[k] - want_mu[k]).max()) <= 1e-3 * scale, k


def test_latent_train_step_matches_jax(image_steps):
    """One step on 32x32 latents: 256 tokens in the mid block, where the
    port's ``FlashAttentionFn`` saves the logsumexp and, with the threshold
    at 256 keys, takes the flash backward (K3's plain version on the
    CPU)."""
    step = image_steps["image"]
    assert len(step["bwd_calls"]) == 1  # the mid block's self-attention at 16x16
    _check_step(step)


def test_video_then_image_only_steps_match_jax(video_steps):
    """A video step, then an ``image_only`` step on single frames on the
    same parameters and optimizer state."""
    _check_step(video_steps["video"])
    assert video_steps["image_only"]["port_count"] == 2
    _check_step(video_steps["image_only"])
    # the mid block's spatial and cross blocks' self-attention
    assert len(video_steps["video"]["bwd_calls"]) == len(video_steps["image_only"]["bwd_calls"]) == 2


@pytest.mark.parametrize("name", ["image", "video", "image_only"])
def test_latent_train_updates_match_jax(request, name):
    """Each leaf's AdamW update (the parameters after the step less those
    before) against JAX's, to 1e-2 of the leaf's largest |update|, where
    AdamW's denominator sqrt(nu_hat) is above ``UPDATE_DENOM_MIN``: an
    update of the wrong size (a bias correction dropped, a step skipped)
    fails here even where the parameters after it stay within 1e-4."""
    step = request.getfixturevalue("video_steps" if name != "image" else "image_steps")[name]
    adam, count = step["jax_adam"], step["jax_count"]
    nu = flatten_tree(adam.nu["params"])
    kept = total = 0
    for k, p0 in step["jax_before"].items():
        want = step["jax_after"][k].astype(np.float64) - p0
        got = step["port_after"][k].astype(np.float64) - step["port_before"][k]
        mask = np.sqrt(np.asarray(nu[k], np.float64) / (1.0 - ptrain.ADAMW_B2**count)) > UPDATE_DENOM_MIN
        kept, total = kept + int(mask.sum()), total + mask.size
        scale = float(np.abs(want).max())
        assert scale > 0, k
        if mask.any():
            err = float(np.abs(got - want)[mask].max())
            assert err <= 1e-2 * scale, (k, err, scale)
    assert kept >= 0.9 * total  # the comparison leaves out few elements


def test_sample_latents_matches_jax(rng):
    """The full ancestral loop with CFG on a 10-timestep schedule, the port
    fed JAX's starting noise and per-step noise."""
    cfg = jtrain.LATENT_SCHEDULE.replace(num_train_timesteps=10)
    shape, ctx = (1, 32, 32, 4), _np(rng, 1, 3, CTX)
    jm, pm = _unet2d()
    params = random_params(jm, np.zeros(shape, np.float32), np.zeros((1,), np.float32), ctx)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jtrain.sample_latents(jm, params, shape, key, jnp.asarray(ctx), 7.5, cfg))
    chain, init_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_key, shape))
    noises = []
    for _ in range(10):
        chain, nkey = jax.random.split(chain)
        noises.append(np.asarray(jax.random.normal(nkey, shape)))
    fed = dict(context=_t(ctx), guidance_scale=7.5,
               schedule_config=ptrain.LATENT_SCHEDULE.replace(num_train_timesteps=10), x0=_t(x0),
               noises=np.stack(noises))
    model = _port(pm, params)
    got = ptrain.sample_latents(model, shape, **fed)
    assert np.isfinite(got.numpy()).all() and maxerr(got.numpy(), want) <= TOL
    assert torch.equal(got, ptrain._sample_latents_eager(model, shape, **fed))


@pytest.mark.parametrize("video", [False, True], ids=["SimpleUNet", "SimpleUNet3D"])
def test_sample_latents_static_program_equals_eager(video):
    """The sampler's static-buffer program (the step the card captures and
    replays) against the eager loop over 24 timesteps, both drawing their
    starting and per-step noise from a generator of one seed: equal bit for
    bit, and the generator left in the same state."""
    _, pm = _unet3d() if video else _unet2d()
    shape = (1, 3, 16, 16, 4) if video else (1, 16, 16, 4)
    kw = dict(context=torch.randn(1, 3, CTX, generator=torch.Generator().manual_seed(2)), guidance_scale=7.5,
              schedule_config=ptrain.LATENT_SCHEDULE.replace(num_train_timesteps=24))
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    got = ptrain.sample_latents(pm, shape, gens[0], **kw)
    want = ptrain._sample_latents_eager(pm, shape, gens[1], **kw)
    assert got.shape == shape and torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_sample_latents_draws_from_its_generator():
    pm = psimple.SimpleUNet(widths=WIDTHS, attention_levels=LEVELS, heads=HEADS, device="cpu")
    cfg = ptrain.LATENT_SCHEDULE.replace(num_train_timesteps=3)
    run = lambda seed: ptrain.sample_latents(pm, (1, 8, 8, 4), torch.Generator().manual_seed(seed),  # noqa: E731
                                             schedule_config=cfg)
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


@pytest.mark.parametrize("video", [False, True], ids=["SimpleUNet", "SimpleUNet3D"])
def test_launch_derivation_matches_dispatch(monkeypatch, video):
    """``chip_smoke.launches_per_simple_eval`` against the calls the zoo
    makes to K1's and K3's wrappers (their plain versions here), with the
    flash backward's threshold moved to 256 keys so that a 32x32 input
    reaches it: one train step and one sampler evaluation."""
    calls = {"flash_attention": 0, "flash_attention_bwd": 0}

    def counting(name):
        fn = getattr(A, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(A, name, counting(name))
    monkeypatch.setattr(A, "FLASH_BWD_MIN_NK", 256)
    zoo = {"widths": WIDTHS, "attention_levels": LEVELS, "heads": HEADS}
    _, pm = _unet3d() if video else _unet2d()
    shape = (2, 3, 32, 32, 4) if video else (2, 32, 32, 4)
    batch = {"latents": torch.zeros(shape), "text_embeds": torch.randn(2, 3, CTX)}
    init_fn, step_fn = (ptrain.make_video_latent_train_step if video else ptrain.make_latent_train_step)(pm)
    step_fn(init_fn(), batch, torch.Generator().manual_seed(0))
    assert calls == chip_smoke.launches_per_simple_eval(zoo, 32, video=video, frames=3, train=True, min_nk=256)
    calls.update(flash_attention=0, flash_attention_bwd=0)
    ptrain.sample_latents(pm, shape[:1] + shape[1:], context=torch.randn(2, 3, CTX),
                          schedule_config=ptrain.LATENT_SCHEDULE.replace(num_train_timesteps=2))
    want = chip_smoke.launches_per_simple_eval(zoo, 32, video=video, frames=3)
    assert calls == {k: 2 * v for k, v in want.items()}


def test_latent_phase_launches_at_full_width():
    """The derivation at the zoo's defaults, as the card run holds it."""
    zoo = chip_smoke.LATENT_ZOO
    assert chip_smoke.launches_per_simple_eval(zoo, 64, train=True) == \
        {"flash_attention": 5, "flash_attention_bwd": 2}
    assert chip_smoke.launches_per_simple_eval(zoo, 32, video=True, frames=16, train=True) == \
        {"flash_attention": 4, "flash_attention_bwd": 0}
    assert chip_smoke.launches_per_simple_eval(zoo, 32) == {"flash_attention": 2, "flash_attention_bwd": 0}
    assert chip_smoke.latent_run_launches(zoo, 5, 1000) == {
        ("flash_attention", 32, 256, 32): 4020, ("flash_attention", 2, 256, 32): 2008,
        ("flash_attention", 8, 1024, 32): 10, ("flash_attention", 8, 256, 64): 15,
        ("flash_attention_bwd", 8, 1024, 32): 10}


# ---------------------------------------------------------------------------
# checkpoints and datasets
# ---------------------------------------------------------------------------


def test_simple_checkpoints_interchange(rng, tmp_path):
    x, t, ctx = _np(rng, 1, 16, 16, 4), np.zeros((1,), np.float32), _np(rng, 1, 3, CTX)
    jm, pm = _unet2d()
    params = _f32(random_params(jm, x, t, ctx))
    jtrain.save_simple_checkpoint(params, str(tmp_path / "jax.safetensors"))
    tree = ptrain.load_simple_checkpoint(str(tmp_path / "jax.safetensors"), pm)
    want = flatten_tree(params["params"])
    for got in (flatten_tree(to_flax_tree(pm)), flatten_tree(tree["params"])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    ptrain.save_simple_checkpoint(pm, str(tmp_path / "port.safetensors"))
    back = flatten_tree(jtrain.load_simple_checkpoint(str(tmp_path / "port.safetensors"))["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_latent_datasets_match_jax(rng, tmp_path):
    frames = [20, 5, 17]
    np.save(tmp_path / "latents.npy", (rng.standard_normal((sum(frames), 4, 4, 4)) * 15).astype(np.float16))
    np.save(tmp_path / "fpv.npy", np.asarray(frames))
    (tmp_path / "prompts.txt").write_text("a\nb\nc")
    (tmp_path / "captions.txt").write_text("\n".join(f"caption {i}" for i in range(sum(frames))))
    for args, kw in (((str(tmp_path / "latents.npy"), str(tmp_path / "captions.txt")), {}),):
        j, p = jlatent.LatentImageDataset(*args, **kw), platent.LatentImageDataset(*args, **kw)
        assert len(j) == len(p) == sum(frames)
        for i in range(len(j)):
            a, b = j[i], p[i]
            np.testing.assert_array_equal(a["latents"], b["latents"])
            assert a["text"] == b["text"] and np.abs(b["latents"]).max() <= 1.0
    for caption in (str(tmp_path / "prompts.txt"), None):
        kw = dict(caption_path=caption, sample_n_frames=16, seed=3)
        j = jlatent.LatentVideoDataset(str(tmp_path / "latents.npy"), str(tmp_path / "fpv.npy"), **kw)
        p = platent.LatentVideoDataset(str(tmp_path / "latents.npy"), str(tmp_path / "fpv.npy"), **kw)
        assert j.videos == p.videos and len(p) == 2
        for i in [0, 1, 1, 0, 1, 0, 0, 1]:
            a, b = j[i], p[i]
            np.testing.assert_array_equal(a["latents"], b["latents"])
            assert a["text"] == b["text"]


def test_image_folder_dataset_matches_jax(rng, tmp_path):
    from PIL import Image

    for i, (cls, size) in enumerate([("cats", (40, 30)), ("cats", (24, 24)), ("dogs", (30, 50)), ("dogs", (17, 33))]):
        (tmp_path / cls).mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(tmp_path / cls / f"{i}.png")
    j = jlatent.ImageFolderDataset(str(tmp_path), sample_size=16, seed=5)
    p = platent.ImageFolderDataset(str(tmp_path), sample_size=16, seed=5)
    assert j.paths == p.paths
    for i in [0, 1, 2, 3, 3, 2, 1, 0]:
        a, b = j[i], p[i]
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
        assert a["text"] == b["text"] and b["pixel_values"].shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# the driver's in-flight async save when the run raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["validation", "write", "both"])
def test_async_save_committed_when_the_run_raises(env, tmp_path, monkeypatch, caplog, fault):  # noqa: F811
    """``--async_checkpoint`` with a save at step 2 whose writer thread
    takes half a second: when validation then raises, the step file is on disk
    and complete as the error reaches the caller, with no temporary left;
    a failed write raises when the run succeeded and is logged beside the
    run's own error when both fail."""
    real_write = pckpt._write_atomic

    def writer(*args, **kwargs):
        if threading.current_thread() is not threading.main_thread():
            time.sleep(0.5)  # still writing when the loop has moved on
            if fault in ("write", "both"):
                raise OSError("disk full")
        return real_write(*args, **kwargs)

    def validation(*args, **kwargs):
        raise RuntimeError("validation failed")

    monkeypatch.setattr(pckpt, "_write_atomic", writer)
    if fault in ("validation", "both"):
        monkeypatch.setattr(pdriver, "_run_validation", validation)
    out = str(tmp_path / "out")
    expected = OSError if fault == "write" else RuntimeError
    with caplog.at_level(logging.ERROR, logger=pdriver.__name__), pytest.raises(expected) as err:
        _train(env, output_dir=out, checkpointing_steps=2, async_checkpoint=True, validation_epoch=1,
               eval_csv_path=env["eval_csv"] if fault != "write" else None)
    state_dir = os.path.join(out, "t", "state")
    assert not [n for n in os.listdir(state_dir) if n.endswith(".tmp")]
    if fault == "validation":
        assert "validation failed" in str(err.value)
        assert os.listdir(state_dir) == ["step_2.safetensors"]
        saved = pckpt.load_file(os.path.join(state_dir, "step_2.safetensors"))
        assert int(saved["step"]) == 2 and len(saved) > 10
    elif fault == "write":
        assert "disk full" in str(err.value) and os.listdir(state_dir) == []
    else:
        assert "validation failed" in str(err.value) and os.listdir(state_dir) == []
        assert any("disk full" in r.getMessage() for r in caplog.records)
