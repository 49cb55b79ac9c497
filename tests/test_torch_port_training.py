"""PyTorch port vs the JAX package: the adapter training step on the CPU.

* one JAX ``make_train_step`` step (jitted) vs the port's step at the tiny
  config, fp32, fed the very numbers ``jax.random`` drew: loss and grad
  norm to 1e-4 relative, every trainable leaf's update to 1e-3 of its
  max |update|;
* the optimizer stack vs optax (clip + AdamW + MultiSteps + warmup, a
  non-finite step), the lr schedules, the loss branches;
* the trainable set vs the JAX ``partition_params``, name for name;
* the config tree and its validation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from i2v_adapter_tpu import config as jconfig
from i2v_adapter_tpu.models import AutoencoderKL as JVAE
from i2v_adapter_tpu.models import CLIPTextEncoder as JText
from i2v_adapter_tpu.models import CLIPVisionEncoder as JVision
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.schedulers import get_velocity as j_get_velocity
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu.training import state as jstate
from i2v_adapter_tpu.training.train_i2v import diffusion_loss as j_diffusion_loss
from i2v_adapter_tpu.training.train_i2v import make_train_step as j_make_train_step
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
from i2v_adapter_tpu_torch.ops import attention as A
from i2v_adapter_tpu_torch.ops import conv3x3
from i2v_adapter_tpu_torch.schedulers import get_velocity, make_schedule
from i2v_adapter_tpu_torch.training import (
    create_train_state,
    diffusion_loss,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    partition_params,
    trainable_predicate,
)
from i2v_adapter_tpu_torch.utils.convert import flatten_tree, load_train_state, to_flax_tree
from tests.torch_port_common import one_torch_thread, random_params  # noqa: F401

B, F, RES, L = 2, 3, 32, 16


def _flat(tree):
    return {k.replace(".", "/"): v for k, v in flatten_tree(tree).items()}


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TrainConfig", "OptimizerConfig", "MeshConfig"])
def test_train_config_tree_matches_jax(name):
    assert getattr(pconfig, name)().to_dict() == getattr(jconfig, name)().to_dict()
    jtc = jconfig.TrainConfig(train_batch_size=2, snr_gamma=5.0,
                              optimizer=jconfig.OptimizerConfig(lr_scheduler="cosine"))
    assert pconfig.TrainConfig.from_dict(jtc.to_dict()).to_dict() == jtc.to_dict()


@pytest.mark.parametrize("kwargs", [dict(train_mode="bogus"), dict(fsdp_frozen="x"),
                                    dict(first_frame_mode="x"),
                                    dict(uncond_prob_t=0.6, uncond_prob_i=0.6)])
def test_train_config_validation_matches_jax(kwargs):
    for mod in (pconfig, jconfig):
        with pytest.raises(ValueError):
            mod.TrainConfig(**kwargs)


def test_unported_training_options_raise():
    """Every training option of the JAX config is ported: a mesh builds, as
    the JAX ``TrainConfig`` takes it (training over it is held in
    tests/test_torch_port_train_mesh.py), and so does Adafactor (held
    against optax in tests/test_torch_port_driver.py)."""
    tc = pconfig.TrainConfig(mesh=pconfig.MeshConfig(data=4))
    assert tc.mesh == pconfig.MeshConfig(data=4)
    assert tc.to_dict() == jconfig.TrainConfig(mesh=jconfig.MeshConfig(data=4)).to_dict()
    assert pconfig.TrainConfig.from_dict(tc.to_dict()).mesh == tc.mesh
    tc = pconfig.TrainConfig(optimizer=pconfig.OptimizerConfig(optimizer="adafactor"))
    assert make_optimizer(tc, 10).kind == "adafactor"


# ---------------------------------------------------------------------------
# optimizer, schedules, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedules_match_optax(sched):
    oc = dict(learning_rate=3e-4, lr_scheduler=sched, lr_warmup_steps=4)
    want = jstate.make_lr_schedule(jconfig.OptimizerConfig(**oc), 12)
    got = make_lr_schedule(pconfig.OptimizerConfig(**oc), 12)
    for count in range(16):  # optax evaluates in fp32, the port in float64
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5, atol=1e-12)


def test_optimizer_stack_matches_optax():
    """(b) Six calls of clip + AdamW + MultiSteps(2) + constant_with_warmup,
    the third emitting call's gradient holding a NaN: the guard zeroes the
    gradient and the update, the moments still advance.  1e-6."""
    kw = dict(gradient_accumulation_steps=2, optimizer=dict(
        learning_rate=1e-2, lr_scheduler="constant_with_warmup", lr_warmup_steps=2,
        max_grad_norm=0.5, adam_weight_decay=0.1))
    jtc = jconfig.TrainConfig.from_dict(kw)
    tx = jstate.make_optimizer(jtc, 6)
    opt = make_optimizer(pconfig.TrainConfig.from_dict(kw), 6)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, tst = tx.init(jp), opt.init(tp)
    for step in range(6):
        grads = {k: (rng.standard_normal(v.shape) * 0.7).astype(np.float32) for k, v in params.items()}
        if step == 3:
            grads["a"][1, 2] = np.nan
        # the train step's guard, on both sides
        jg = {k: jnp.asarray(v) for k, v in grads.items()}
        ok = jnp.isfinite(jnp.sqrt(sum(jnp.sum(g * g) for g in jg.values())))
        jg = {k: jnp.where(ok, g, 0.0) for k, g in jg.items()}
        upd, jst = tx.update(jg, jst, jp)
        jp = {k: jp[k] + jnp.where(ok, upd[k], 0.0) for k in jp}
        tg = {k: torch.from_numpy(v) for k, v in grads.items()}
        tok = torch.isfinite(torch.sqrt(sum((g * g).sum() for g in tg.values())))
        tg = {k: torch.where(tok, g, torch.zeros_like(g)) for k, g in tg.items()}
        tupd = opt.update(tg, tst, tp)
        tp = {k: tp[k] + torch.where(tok, tupd[k], torch.zeros_like(tupd[k])) for k in tp}
        assert bool(tok) == bool(ok) == (step != 3)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} leaf {k}")
    assert tst.count == 3 and tst.gradient_step == 3


@pytest.mark.parametrize("pred_type,snr_gamma,exclude", [
    ("epsilon", None, True), ("epsilon", None, False), ("epsilon", 5.0, True),
    ("v_prediction", 5.0, True)])
def test_diffusion_loss_and_velocity_match(pred_type, snr_gamma, exclude):
    rng = np.random.default_rng(1)
    x0, noise, pred = (rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32) for _ in range(3))
    t = np.array([15, 870])
    jsched = j_make_schedule(jconfig.SchedulerConfig(prediction_type=pred_type))
    psched = make_schedule(pconfig.SchedulerConfig(prediction_type=pred_type))
    jv = j_get_velocity(jsched, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    pv = get_velocity(psched, *(torch.from_numpy(a) for a in (x0, noise, t)))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    want = j_diffusion_loss(jnp.asarray(pred), jv, jnp.asarray(t), jsched, snr_gamma, exclude)
    got = diffusion_loss(torch.from_numpy(pred), pv, torch.from_numpy(t), psched, snr_gamma, exclude)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# models, trainable set, the step
# ---------------------------------------------------------------------------


def _jax_params():
    mc = jconfig.tiny_test_config()
    ucfg = mc.unet.replace(flash_static_max=0.0)
    lat = RES // mc.vae.spatial_scale_factor
    unet = random_params(JUNet(ucfg), jnp.zeros((B, F, lat, lat, 4)), jnp.zeros((B,)),
                         jnp.zeros((B, L, ucfg.cross_attention_dim)),
                         jnp.zeros((B, ucfg.image_embed_dim)), seed=1,
                         enable_cross_frame_attn=True)
    vae = random_params(JVAE(mc.vae), jnp.zeros((2, RES, RES, 3)), seed=2)
    text = random_params(JText(mc.text_encoder), jnp.zeros((2, L), jnp.int32), seed=3)
    size = mc.image_encoder.image_size
    image = random_params(JVision(mc.image_encoder), jnp.zeros((2, size, size, 3)), seed=4)
    return mc.replace(unet=ucfg), unet, vae, text, image


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


def _port_models(mc):
    pc = pconfig.I2VModelConfig.from_dict(mc.to_dict())
    return pc, (VideoUNet(pc.unet, device="cpu"), AutoencoderKL(pc.vae, device="cpu"),
                CLIPTextEncoder(pc.text_encoder, device="cpu"),
                CLIPVisionEncoder(pc.image_encoder, device="cpu"))


@pytest.mark.parametrize("kwargs", [dict(), dict(update_motion_modules=True),
                                    dict(train_mode="t2i")], ids=["i2v", "i2v_motion", "t2i"])
def test_trainable_set_matches_jax(jax_params, kwargs):
    """(g) The port's trainable names, carried to Flax names, are the JAX
    ``partition_params`` trainable leaves."""
    mc, unet_params = jax_params[:2]
    jtrain, _ = jstate.partition_params(unet_params["params"],
                                        jstate.trainable_predicate(jconfig.TrainConfig(**kwargs)))
    unet = _port_models(mc)[1][0]
    names, frozen = partition_params(unet, trainable_predicate(pconfig.TrainConfig(**kwargs)))
    named = dict(unet.named_parameters())
    assert set(_flat(to_flax_tree(unet, {n: named[n] for n in names}))) == set(_flat(jtrain))
    assert all(p.requires_grad == (n in names) for n, p in unet.named_parameters())
    assert len(names) + len(frozen) == len(list(unet.parameters()))


def _draws(rng, b, f, lat, tc):
    """The numbers the JAX ``loss_fn`` draws from ``rng`` (its 6-way split)."""
    r_t, r_noise, r_off, r_pert, r_vae, r_drop = jax.random.split(rng, 6)
    shape = (b, f, lat, lat, 4)
    return {
        "timesteps": jax.random.randint(r_t, (b,), 1 if tc.first_frame_mode == "exact" else 0, 1000),
        "noise": jax.random.normal(r_noise, shape, dtype=jnp.float32),
        "offset": jax.random.normal(r_off, (b, f, 1, 1, 4), dtype=jnp.float32),
        "perturbation": jax.random.normal(r_pert, shape, dtype=jnp.float32),
        "posterior_noise": jax.random.normal(r_vae, (b * f, lat, lat, 4), dtype=jnp.float32),
        "drop_uniform": jax.random.uniform(r_drop, (b,)),
    }


@pytest.mark.parametrize("options", [dict(), dict(first_frame_mode="exact"), dict(snr_gamma=5.0),
                                     dict(use_ema=True, ema_decay=0.9)],
                         ids=["i2v", "first_frame_exact", "snr_gamma", "ema"])
def test_train_step_matches_jax(jax_params, options):
    """(a) One step at the tiny config: mixed_precision none, i2v, epsilon,
    offset noise and input perturbation on, condition dropout chosen so the
    batch holds a text drop and an image drop; then the same with
    ``first_frame_mode='exact'`` (clean first frame, timesteps from 1), with
    the SNR-gamma loss weighting, and with an EMA of the trainables (its
    tree after the step to 1e-6 of its max, as the update).  Adam with
    eps = 1 and no decay makes the first update lr * g / (|g| + 1), smooth
    in g; lr = 1 keeps the updates far above the fp32 spacing of the O(1)
    weights they are added to (at lr = 1e-4 that spacing is a few percent
    of them)."""
    mc, unet_params, vae_params, text_params, image_params = jax_params
    jtc = jconfig.TrainConfig(
        train_batch_size=B, num_frames=F, resolution=RES, gradient_accumulation_steps=1,
        mixed_precision="none", uncond_prob_t=0.3, uncond_prob_i=0.3, noise_offset=0.1,
        input_perturbation=0.05,
        optimizer=jconfig.OptimizerConfig(learning_rate=1.0, adam_epsilon=1.0,
                                          adam_weight_decay=0.0), **options)
    lat = RES // mc.vae.spatial_scale_factor
    for seed in range(64):  # a key whose dropout uniforms give both drops
        draws = _draws(jax.random.PRNGKey(seed), B, F, lat, jtc)
        u = np.asarray(draws["drop_uniform"])
        if (u < 0.3).any() and ((u >= 0.3) & (u < 0.6)).any():
            break
    else:
        pytest.fail("no key with both drops")
    rng = np.random.default_rng(5)
    batch = {
        "pixel_values": rng.uniform(-1, 1, (B, F, RES, RES, 3)).astype(np.float32),
        "text_ids": rng.integers(0, 1000, (B, L)).astype(np.int32),
        "uncond_ids": np.zeros((B, L), np.int32),
        "clip_image": rng.standard_normal((B, 28, 28, 3)).astype(np.float32),
    }
    jst, tx = jstate.create_train_state(unet_params, jtc, 10, vae_params, text_params, image_params)
    jnew, jm = j_make_train_step(mc, jtc, tx, donate=False)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(seed))

    pc, (unet, vae, text, image) = _port_models(mc)
    ptc = pconfig.TrainConfig.from_dict(jtc.to_dict())
    pst = load_train_state(create_train_state(unet, ptc, 10, vae, text, image), jst)
    before = {n: p.detach().clone() for n, p in pst.trainable_params().items()}
    pst, pm = make_train_step(pc, ptc, device="cpu")(
        pst, batch, draws={k: np.asarray(v) for k, v in draws.items()})

    assert float(pm["skipped_nonfinite"]) == float(jm["skipped_nonfinite"]) == 0.0
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-4)
    delta = {n: p.detach() - before[n] for n, p in pst.trainable_params().items()}
    got = _flat(to_flax_tree(unet, delta))
    old, new = _flat(jst.trainable), _flat(jnew.trainable)
    assert set(got) == set(new)
    for name, d in got.items():
        want = np.asarray(new[name]) - np.asarray(old[name])
        err = float(np.max(np.abs(d - want)))
        assert err <= 1e-3 * float(np.max(np.abs(want))), f"{name}: {err}"
    assert (pst.ema is None) == (jnew.ema is None) == (not jtc.use_ema)
    if jtc.use_ema:
        ema = _flat(to_flax_tree(unet, pst.ema))
        jema = _flat(jnew.ema)
        assert set(ema) == set(jema)
        for name, value in ema.items():
            want = np.asarray(jema[name])
            err = float(np.max(np.abs(value - want)))
            assert err <= 1e-6 * float(np.max(np.abs(want))) + 1e-3 * (1 - jtc.ema_decay) * float(
                np.max(np.abs(np.asarray(new[name]) - np.asarray(old[name])))), f"ema {name}: {err}"


def test_train_launch_derivation_matches_the_model(monkeypatch):
    """chip_smoke's per-step launch counts (K1, K2, K3 with remat) equal
    the wrapper calls of a real tiny train step, the flash-backward
    threshold lowered to the 256-token sites."""
    monkeypatch.setattr(A, "FLASH_BWD_MIN_NK", 256)
    calls = {"flash_attention": 0, "flash_attention_bwd": 0, "temporal_attention_cs": 0,
             "conv3x3_kernel": 0}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    for name in calls:
        module = conv3x3 if name == "conv3x3_kernel" else A
        monkeypatch.setattr(module, name, counting(module, name))
    from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state

    mc = pconfig.tiny_test_config()
    tc = pconfig.TrainConfig(train_batch_size=2, num_frames=2, resolution=32,
                             gradient_accumulation_steps=1, gradient_checkpointing=True,
                             mixed_precision="none")
    state = random_train_state(mc, tc, "cpu")
    make_train_step(mc, tc, device="cpu")(state, random_train_batch(mc, tc, "cpu"))
    assert calls == chip_smoke.launches_per_train_step(mc.unet, 16, tc, min_nk=256)
    assert chip_smoke.launches_per_train_step(
        pconfig.VideoUNetConfig(), 32, dataclasses.replace(tc, train_mode="i2v")) == {
        "flash_attention": 40, "flash_attention_bwd": 9, "temporal_attention_cs": 40,
        "conv3x3_kernel": 0}
