"""The slice as a whole: the port's I2VAdapterPipeline vs the JAX package's
``_build_parts`` at the tiny config, fp32, exact convs, on the CPU.

* the denoise loop (first-frame clamp, CFG-doubled UNet, guidance, DDIM)
  plus the final clamp and VAE decode, fed identical consts and initial
  latents: decoded video max error <= 1e-3 and PSNR > 35 dB; with a
  condition image and CFG, without a condition image, without CFG
  (guidance 1.0), and with ``eta = 0.5`` (the port fed the JAX draws);
* ``prep`` against the JAX encoders, VAE posterior, blur and prior, with
  the posterior noise, mask draw and prior noise fed from numpy;
* ``__call__`` against the JAX ``__call__`` for ``output_type='latent'``
  (1e-4) and ``'pt'`` (as the loop), the port fed the JAX draws;
* ``__call__`` end to end: shape, dtype, determinism for a fixed seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.config import PipelineConfig as JPipelineConfig
from i2v_adapter_tpu.config import tiny_test_config as j_tiny
from i2v_adapter_tpu.models import AutoencoderKL as JVAE
from i2v_adapter_tpu.models import CLIPTextEncoder as JText
from i2v_adapter_tpu.models import CLIPVisionEncoder as JVision
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.ops.blur import gaussian_blur as j_blur
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.schedulers import add_noise as j_add_noise
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu.utils.tokenizer import make_test_tokenizer as j_make_test_tokenizer
from i2v_adapter_tpu_torch.config import PipelineConfig, tiny_test_config
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.utils.tokenizer import make_test_tokenizer
from tests.torch_port_common import maxerr, one_torch_thread, psnr, random_params  # noqa: F401

B, F, LAT, STEPS, GUIDANCE = 1, 2, 16, 2, 7.5
EXACT = dict(flash_attention=False, fast_gelu=False, flash_static_max=0.0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = j_tiny()
    jcfg = jcfg.replace(unet=jcfg.unet.replace(**EXACT))
    size = LAT * jcfg.vae.spatial_scale_factor
    rng = np.random.default_rng(0)
    ucfg = jcfg.unet
    params = {
        "unet": random_params(
            JUNet(ucfg), jnp.zeros((1, F, LAT, LAT, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 7, ucfg.cross_attention_dim)), jnp.zeros((1, ucfg.image_embed_dim)),
            seed=1, enable_cross_frame_attn=True,
        ),
        "vae": random_params(JVAE(jcfg.vae), jnp.zeros((1, size, size, 3)), seed=2),
        "text_encoder": random_params(JText(jcfg.text_encoder), jnp.zeros((1, 16), jnp.int32), seed=3),
        "image_encoder": random_params(
            JVision(jcfg.image_encoder),
            jnp.zeros((1, jcfg.image_encoder.image_size, jcfg.image_encoder.image_size, 3)), seed=4,
        ),
    }
    tok = make_test_tokenizer(str(tmp_path_factory.mktemp("tok")))
    # the port runs its auto dispatch (kernel wrappers -> plain math on the
    # CPU) with the exact softmax; the JAX side runs its XLA path
    pcfg = tiny_test_config()
    pcfg = pcfg.replace(unet=pcfg.unet.replace(flash_static_max=0.0))
    pipe_cfg = PipelineConfig(num_frames=F, height=size, width=size, num_inference_steps=STEPS,
                              blur_sigma=1.0, dtype="float32", int8_conv=False)
    pipe = I2VAdapterPipeline(pcfg, params, tok, pipe_cfg, device="cpu")
    return {"jcfg": jcfg, "params": params, "pipe": pipe, "size": size, "rng": rng}


def _jax_pipe(jcfg, size, eta=0.0):
    pipe = JPipeline.__new__(JPipeline)
    pipe.config = jcfg
    pipe.pipe_config = JPipelineConfig(num_frames=F, height=size, width=size,
                                       num_inference_steps=STEPS, dtype="float32",
                                       blur_sigma=1.0, int8_conv=False, eta=eta)
    pipe.dtype = jnp.float32
    pipe.unet = JUNet(jcfg.unet)
    pipe.vae = JVAE(jcfg.vae)
    pipe.text_encoder = JText(jcfg.text_encoder)
    pipe.image_encoder = JVision(jcfg.image_encoder)
    pipe.schedule = j_make_schedule(jcfg.scheduler)
    return pipe


@pytest.mark.parametrize("use_cfg,has_condition,eta", [
    (True, True, 0.0), (True, False, 0.0), (False, True, 0.0), (True, True, 0.5)],
    ids=["cfg_condition", "no_condition", "guidance_1", "eta"])
def test_denoise_and_decode_loop_matches_jax(setup, use_cfg, has_condition, eta):
    jcfg, size, rng = setup["jcfg"], setup["size"], setup["rng"]
    ucfg = jcfg.unet
    guidance = GUIDANCE if use_cfg else 1.0
    evals = 2 * B if use_cfg else B
    inputs = {
        "latents0": rng.standard_normal((B, F, LAT, LAT, 4)).astype(np.float32),
        "cond_latents": rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32),
        "text_states": (rng.standard_normal((evals, 16, ucfg.cross_attention_dim)) * 0.5).astype(np.float32),
        "image_embeds": rng.standard_normal((evals, ucfg.image_embed_dim)).astype(np.float32),
    }
    names = ("cond_latents", "text_states", "image_embeds")
    jpipe = _jax_pipe(jcfg, size, eta)
    _, j_step, j_decode, ts, prev, _ = jpipe._build_parts(
        B, F, size, size, STEPS, 1.0, guidance, use_cfg, has_condition, 0, False, 1
    )
    jparams = {k: setup["params"][k] for k in ("unet", "vae")}
    consts = tuple(None if (k == "cond_latents" and not has_condition) else jnp.asarray(inputs[k])
                   for k in names)
    key = jax.random.PRNGKey(0)
    carry = (jnp.asarray(inputs["latents0"]), key)
    j_step = jax.jit(j_step)
    eta_draws = []
    for t, tp in zip(ts, prev):
        if eta > 0:  # the draw the JAX step makes from its carried key
            key, nkey = jax.random.split(key)
            eta_draws.append(np.asarray(jax.random.normal(nkey, (B, F, LAT, LAT, 4), jnp.float32)))
        carry = j_step(jparams, consts, carry, jnp.asarray(t), jnp.asarray(tp))
    want = np.asarray(jax.jit(j_decode)(jparams, consts, carry[0])).reshape(B, F, size, size, 3)

    pipe = setup["pipe"]
    if eta > 0:  # the same modules under a config with eta
        pipe = I2VAdapterPipeline(pipe.config, {"unet": pipe.unet, "vae": pipe.vae,
                                                "text_encoder": pipe.text_encoder,
                                                "image_encoder": pipe.image_encoder},
                                  pipe.tokenizer, pipe.pipe_config.replace(eta=eta), device="cpu")
    _, step, decode, pts, pprev, _ = pipe._build_parts(B, F, size, size, STEPS, 1.0, guidance, use_cfg,
                                                    has_condition)
    np.testing.assert_array_equal(pts, ts)
    pconsts = tuple(None if c is None else torch.tensor(np.asarray(c)) for c in consts)
    latents = torch.from_numpy(inputs["latents0"])
    with torch.no_grad():
        for i, (t, tp) in enumerate(zip(pts, pprev)):
            noise = torch.from_numpy(eta_draws[i]) if eta > 0 else None
            latents = step(pconsts, latents, t, tp, eta_noise=noise)
        got = decode(pconsts, latents).numpy()
    assert got.shape == want.shape
    assert maxerr(got, want) <= 1e-3
    assert psnr(got, want) > 35.0


def test_prep_matches_jax_encoders_and_prior(setup):
    jcfg, size, params = setup["jcfg"], setup["size"], setup["params"]
    rng = np.random.default_rng(5)
    pipe = setup["pipe"]
    lat_shape = (B, F, LAT, LAT, 4)
    text_ids = pipe.tokenizer(["", "a cat"])
    isz = jcfg.image_encoder.image_size
    cond = rng.uniform(-1, 1, (B, size, size, 3)).astype(np.float32)
    clip_img = rng.standard_normal((B, isz, isz, 3)).astype(np.float32)
    post_noise = rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32)
    mask_u = rng.uniform(size=lat_shape).astype(np.float32)
    prior_noise = rng.standard_normal(lat_shape).astype(np.float32)

    prep, _, _, ts, _, _ = pipe._build_parts(B, F, size, size, 5, 0.9, GUIDANCE, True, True)
    with torch.no_grad():
        latents, (cond_latents, text_states, image_embeds) = prep(
            text_ids, cond, clip_img, posterior_noise=torch.from_numpy(post_noise),
            mask_uniform=torch.from_numpy(mask_u), prior_noise=torch.from_numpy(prior_noise),
        )

    j_text = JText(jcfg.text_encoder).apply(params["text_encoder"], jnp.asarray(text_ids))
    assert maxerr(text_states.numpy(), j_text) < 1e-4
    j_emb = JVision(jcfg.image_encoder).apply(params["image_encoder"], jnp.asarray(clip_img))
    assert maxerr(image_embeds.numpy(), np.concatenate([np.zeros_like(j_emb), j_emb])) < 1e-4
    vae = JVAE(jcfg.vae)
    mean, logvar = vae.apply(params["vae"], jnp.asarray(cond), method=vae.encode_moments)
    j_cond = (mean + jnp.exp(0.5 * logvar) * post_noise) * jcfg.vae.scaling_factor
    assert maxerr(cond_latents.numpy(), j_cond) < 1e-4
    mask = (mask_u < 0.6).astype(np.float32)
    blurred = j_blur(j_cond, 3, 1.0)
    prior = mask * blurred[:, None] + (1 - mask) * j_cond[:, None]
    j_lat = j_add_noise(j_make_schedule(jcfg.scheduler), prior, jnp.asarray(prior_noise),
                        jnp.full((B,), int(ts[0])))
    assert maxerr(latents.numpy(), j_lat) < 1e-4


def test_call_end_to_end_is_deterministic(setup):
    pipe, size = setup["pipe"], setup["size"]
    image = np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)
    a = pipe("a cat", condition_image=image, seed=3)
    b = pipe("a cat", condition_image=image, seed=3)
    c = pipe("a cat", condition_image=image, seed=4)
    assert a.shape == (1, F, size, size, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert np.any(a != c)
    assert set(pipe.last_timings) == {"prep_ms", "step_ms", "decode_ms"}
    assert len(pipe.last_timings["step_ms"]) == int(STEPS * 0.9)


def test_call_without_condition_image(setup):
    pipe, size = setup["pipe"], setup["size"]
    video = pipe(["a dog", "a cat"], seed=0, output_type="float")
    assert video.shape == (2, F, size, size, 3) and video.dtype == np.float32
    assert np.isfinite(video).all()


def test_output_types_match_jax_call(setup, tmp_path, monkeypatch):
    """``__call__`` with ``output_type='latent'`` (the clamped final latents,
    no decode) against the JAX ``__call__`` with the same seed, and
    ``'pt'`` (float video) against the JAX decode of the JAX latents; the
    port's prep is fed the draws JAX makes from the seed."""
    jcfg, size, params = setup["jcfg"], setup["size"], setup["params"]
    jpipe = JPipeline(jcfg, params, j_make_test_tokenizer(str(tmp_path)),
                      _jax_pipe(jcfg, size).pipe_config)
    image = np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)
    seed = 3
    want_latents = jpipe("a cat", condition_image=image, seed=seed, output_type="latent")
    # 'pt' is the decode of those latents (JAX __call__ runs its scan sampler
    # there, a second whole-loop compile): the JAX decode part, whose
    # first-frame clamp is a no-op on latents already clamped
    decode = jpipe._build_parts(B, F, size, size, STEPS, 0.9, GUIDANCE, True, True, 0, False, 1)[2]
    jl = jnp.asarray(want_latents)
    want_video = np.asarray(jax.jit(decode)({"vae": params["vae"]}, (jl[:, 0], None, None), jl))
    want_video = want_video.reshape(B, F, size, size, 3)

    _, k_prior, k_mask, k_vae, _, _ = jax.random.split(jax.random.PRNGKey(seed), 6)
    shape = (B, F, LAT, LAT, 4)
    draws = {"posterior_noise": jax.random.normal(k_vae, (B, LAT, LAT, 4), jnp.float32),
             "mask_uniform": jax.random.uniform(k_mask, shape),
             "prior_noise": jax.random.normal(k_prior, shape, jnp.float32)}
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
    pipe = setup["pipe"]
    build = pipe._build_parts

    def fed(*args):
        prep, *rest = build(*args)
        return (lambda *a, **k: prep(*a, **k, **draws), *rest)

    monkeypatch.setattr(pipe, "_build_parts", fed)
    got_latents = pipe("a cat", condition_image=image, seed=seed, output_type="latent")
    assert "decode_ms" not in pipe.last_timings
    got_video = pipe("a cat", condition_image=image, seed=seed, output_type="pt")
    assert got_latents.shape == want_latents.shape == shape and got_latents.dtype == np.float32
    assert maxerr(got_latents, want_latents) < 1e-4
    assert got_video.shape == want_video.shape and got_video.dtype == np.float32
    assert maxerr(got_video, want_video) <= 1e-3 and psnr(got_video, want_video) > 35.0
    with pytest.raises(ValueError, match="output_type"):
        pipe("a cat", condition_image=image, output_type="gif")
