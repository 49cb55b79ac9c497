"""PyTorch port vs the JAX package: the int8 serving convs on the CPU, fp32,
tiny sizes.

* the plain int32 conv on given int8 arrays vs ``lax.conv_general_dilated``
  (int32 accumulation) in the stride-1, stride-2 and VALID cases: equal;
* ``ops.int8.int8_conv`` vs the JAX ``layers.int8_conv``: 1e-6 of max |JAX|;
* ``ResnetBlock2D`` / ``Downsample2D`` / ``Upsample2D`` with int8 and the
  int8 VAE decoder vs the Flax modules on the same tree: 1e-5 of max;
* a tiny int8 UNet evaluation and the serving default's denoise loop and
  decode (``PipelineConfig()`` but fp32) vs JAX, bucket-flip aware (below);
* ``PipelineConfig()`` itself (bf16, int8) builds and serves;
* the int8 launch derivation of ``chip_smoke`` vs a counted tiny model.

Bucket flips.  ``round(x / xs)`` is discontinuous: a value within an ulp of
a .5 edge may land in the neighbouring bucket in one graph and not in the
other, and at whole-model level one flip spreads through the attention to
every output (a 1e-6 relative nudge of the UNet's input moves its int8
output by 1.4e-2 of max, int8 vs exact convs 2.7e-2; measured at this
config).  So the whole-model checks run twice:

* teacher-forced: the JAX side records every int8 site's quantised
  activation in order (``jax.debug.callback``) and the port's int8 convs
  take the JAX buckets where theirs differ.  Then at most 1e-3 of a site's
  values may differ from JAX's, each by one bucket, the site counts and
  order must agree, and the outputs agree to 1e-4 of max, as for exact
  convs;
* free-running: the port's own int8 path, within three quantisation steps
  (3/127 of max |JAX|) and PSNR > 35 dB; eight steps through the two-step
  denoise loop and decode, whose flips compound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from i2v_adapter_tpu.config import PipelineConfig as JPipelineConfig
from i2v_adapter_tpu.config import tiny_test_config as j_tiny
from i2v_adapter_tpu.models import AutoencoderKL as JVAE
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.models import layers as jlayers
from i2v_adapter_tpu.models.layers import Downsample2D as JDown
from i2v_adapter_tpu.models.layers import ResnetBlock2D as JResnet
from i2v_adapter_tpu.models.layers import Upsample2D as JUp
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.models import AutoencoderKL, VideoUNet
from i2v_adapter_tpu_torch.models import layers as player
from i2v_adapter_tpu_torch.models.layers import Downsample2D, ResnetBlock2D, Upsample2D
from i2v_adapter_tpu_torch.ops import int8 as I
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.utils.convert import load_flax_params
from i2v_adapter_tpu_torch.utils.random_init import random_pipeline
from tests.torch_port_common import maxerr, one_torch_thread, psnr, random_params  # noqa: F401

T = torch.from_numpy
EXACT = dict(flash_attention=False, fast_gelu=False, flash_static_max=0.0)
# (stride, JAX padding, port padding)
CASES = [(1, "SAME", 1), (2, ((1, 1), (1, 1)), 1), (2, "VALID", 0)]
CASE_IDS = ["stride1", "stride2", "valid"]
FLIP_FRAC_MAX = 1e-3
FREE_MAX_STEPS = 3
# two denoise steps and the decode, each with flips of its own (measured 5.6)
LOOP_FREE_MAX_STEPS = 8


def _rng_arrays(seed, b, h, w, c, co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) / (3 * c) ** 0.5).astype(np.float32)
    bias = rng.standard_normal((co,)).astype(np.float32)
    return x, k, bias


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride,jpad,pad", CASES, ids=CASE_IDS)
def test_plain_int32_conv_matches_lax(stride, jpad, pad):
    rng = np.random.default_rng(stride + pad)
    xq = rng.integers(-127, 128, (2, 9, 11, 32)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, 32, 24)).astype(np.int8)  # HWIO
    want = jax.lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(wq), (stride, stride), jpad,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    got = I.int8_conv_int32_plain(T(xq), T(wq).permute(3, 0, 1, 2).contiguous(), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride,jpad,pad", CASES, ids=CASE_IDS)
def test_int8_conv_matches_jax(stride, jpad, pad):
    x, k, bias = _rng_arrays(stride * 3 + pad, 2, 9, 9, 16, 24)
    want = jlayers.int8_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                             strides=(stride, stride), padding=jpad)
    I.reset_launch_counts()
    got = I.int8_conv(T(x), T(k), T(bias), stride=stride, padding=pad)
    assert I.launch_counts() == {"int8_conv3x3_kernel": 0, "quantize_weights": 0}  # a CPU tensor launches nothing
    assert got.shape == want.shape and got.dtype == torch.float32
    assert maxerr(got.numpy(), want) <= 1e-6
    # the quantiser: weights from the fp32 parameter, one activation scale
    wq, ws = I.quantize_weight(T(k))
    jws = jnp.max(jnp.abs(jnp.asarray(k)), axis=(0, 1, 2)) / 127.0
    np.testing.assert_array_equal(wq.permute(1, 2, 3, 0).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(k) / jws).astype(jnp.int8)))
    assert float(I.activation_scale(T(x))) == float(np.abs(x).max() / np.float32(127.0))


def test_int8_conv_rejects_other_paddings():
    x, k, bias = _rng_arrays(0, 1, 4, 4, 16, 16)
    with pytest.raises(ValueError, match="padding"):
        I.int8_conv(T(x), T(k), T(bias), padding=2)


# ---------------------------------------------------------------------------
# modules and whole models, bucket-flip aware
# ---------------------------------------------------------------------------


class Forcing:
    """Teacher forcing of the int8 buckets (see the module docstring):
    ``record`` patches the JAX ``int8_conv`` to log each site's quantised
    activation, ``force`` patches the port's to take the logged buckets and
    to tally where its own differ."""

    def __init__(self, monkeypatch):
        self.mp, self.log, self.sites = monkeypatch, [], []

    def record(self):
        real = jlayers.int8_conv

        def recording(x, kernel, bias, strides=(1, 1), padding="SAME"):
            xs = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32))), 1e-12) / 127.0
            xq = jnp.round(x.astype(jnp.float32) / xs).astype(jnp.int8)
            jax.debug.callback(lambda q: self.log.append(np.asarray(q)), xq, ordered=True)
            return real(x, kernel, bias, strides, padding)

        self.mp.setattr(jlayers, "int8_conv", recording)

    def force(self):
        def forced(x, kernel, bias, stride=1, padding=1, absmax=None):
            want = self.log[len(self.sites)]
            wq, ws = I.quantize_weight(kernel)
            xs = I.activation_scale(x) if absmax is None else I.absmax_scale(absmax)
            xq = I.quantize_activation(x, xs)
            diff = (xq.int() - torch.tensor(want).int()).abs()
            self.sites.append({"shape": tuple(xq.shape), "flips": int((diff > 0).sum()),
                               "max_buckets": int(diff.max()), "size": xq.numel()})
            y = I.int8_conv_int32_plain(torch.tensor(want), wq, stride, padding)
            return I.dequantize(y, xs, ws, bias, x.dtype)

        self.mp.setattr(player, "int8_conv", forced)

    def check(self):
        assert len(self.sites) == len(self.log) > 0
        for s, want in zip(self.sites, self.log):
            assert s["shape"] == want.shape
            assert s["flips"] <= FLIP_FRAC_MAX * s["size"] and s["max_buckets"] <= 1, s


def _free_running_ok(got, want, steps=FREE_MAX_STEPS):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))
    return err <= steps / 127.0 * float(np.max(np.abs(want))) and psnr(got, want) > 35.0


def _check(monkeypatch, jax_fn, port_fn, tol):
    """``jax_fn()`` (recorded) against ``port_fn()`` free-running and
    teacher-forced; returns the forced sites."""
    forcing = Forcing(monkeypatch)
    forcing.record()
    want = np.asarray(jax_fn())
    jax.effects_barrier()
    with torch.no_grad():
        free = port_fn()
        forcing.force()
        forced = port_fn()
    forcing.check()
    assert forced.shape == want.shape
    assert maxerr(forced, want) <= tol
    assert _free_running_ok(free, want)
    return forcing.sites


@pytest.mark.parametrize("kind", ["resnet", "resnet_shortcut", "downsample", "upsample"])
def test_int8_layers_match_flax(kind, monkeypatch):
    rng = np.random.default_rng(len(kind))
    cin, cout = (16, 32) if kind == "resnet_shortcut" else (16, 16)
    x = rng.standard_normal((2, 8, 8, cin)).astype(np.float32)
    if kind.startswith("resnet"):
        temb = rng.standard_normal((2, 64)).astype(np.float32)
        jm, args = JResnet(out_channels=cout, groups=8, int8=True), (x, temb)
        pm = ResnetBlock2D(cin, cout, 64, groups=8, int8=True)
    elif kind == "downsample":
        jm, args, pm = JDown(cout, int8=True), (x,), Downsample2D(cin, cout, int8=True)
    else:
        jm, args, pm = JUp(cout, int8=True), (x,), Upsample2D(cin, cout, int8=True)
    params = random_params(jm, *(jnp.asarray(a) for a in args), seed=1)
    load_flax_params(pm, params)
    sites = _check(monkeypatch, lambda: jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in args)),
                   lambda: pm(*(T(a) for a in args)).numpy(), 1e-5)
    assert len(sites) == (2 if kind.startswith("resnet") else 1)


def test_int8_vae_decoder_matches_flax(monkeypatch):
    vcfg = j_tiny().vae.replace(int8_decode=True)
    jm = JVAE(vcfg)
    params = random_params(jm, jnp.zeros((1, 32, 32, 3)), seed=10)
    z = np.random.default_rng(11).standard_normal((2, 16, 16, 4)).astype(np.float32)
    pm = load_flax_params(AutoencoderKL(pconfig.tiny_test_config().vae.replace(int8_decode=True),
                                        device="cpu"), params)
    sites = _check(monkeypatch,
                   lambda: jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(params, jnp.asarray(z)),
                   lambda: pm.decode(T(z)).numpy(), 1e-5)
    assert len(sites) == sum(n for *_, n in chip_smoke.int8_decoder_sites(vcfg, 16))
    # the encoder stays exact: int8 only in the decoder
    assert not any(m.int8 for m in pm.encoder.modules() if isinstance(m, ResnetBlock2D))


def test_int8_unet_matches_jax(monkeypatch):
    """One tiny evaluation (CFG batch of 2 clips, 2 frames, IP, cross-frame)
    with int8 resnet, down and upsample convs on both sides."""
    ucfg = j_tiny().unet.replace(int8_conv=True, **EXACT)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 2, 16, 16, 4)).astype(np.float32)
    txt = (rng.standard_normal((2, 7, ucfg.cross_attention_dim)) * 0.5).astype(np.float32)
    img = rng.standard_normal((2, ucfg.image_embed_dim)).astype(np.float32)
    t = np.array([421.0, 421.0], np.float32)
    args = (x, t, txt, img)
    params = random_params(JUNet(ucfg), *(jnp.asarray(a) for a in args), seed=7,
                           enable_cross_frame_attn=True)
    pcfg = pconfig.tiny_test_config().unet.replace(int8_conv=True, flash_static_max=0.0,
                                                   fast_gelu=False)
    pm = load_flax_params(VideoUNet(pcfg, device="cpu"), params)
    sites = _check(
        monkeypatch,
        lambda: jax.jit(lambda p, *a: JUNet(ucfg).apply(p, *a, enable_cross_frame_attn=True))(
            params, *(jnp.asarray(a) for a in args)),
        lambda: pm(*(T(a) for a in args), enable_cross_frame_attn=True).numpy(), 1e-4)
    assert len(sites) == sum(n for *_, n in chip_smoke.int8_unet_sites(pcfg, 16)) + sum(
        n for *_, n in chip_smoke.int8_downsample_sites(pcfg, 16))


def test_int8_serving_default_loop_matches_jax(monkeypatch, tmp_path):
    """The serving default's numerics (``PipelineConfig()``'s int8 convs, fp32
    here) through the denoise loop and the decode, the JAX ``_build_parts``
    against the port's, fed the same consts and initial latents."""
    b, f, lat, steps = 1, 2, 16, 2
    jcfg = j_tiny()
    jcfg = jcfg.replace(unet=jcfg.unet.replace(int8_conv=True, **EXACT),
                        vae=jcfg.vae.replace(int8_decode=True))
    size = lat * jcfg.vae.spatial_scale_factor
    ucfg = jcfg.unet
    params = {
        "unet": random_params(JUNet(ucfg), jnp.zeros((1, f, lat, lat, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 7, ucfg.cross_attention_dim)),
                              jnp.zeros((1, ucfg.image_embed_dim)), seed=1,
                              enable_cross_frame_attn=True),
        "vae": random_params(JVAE(jcfg.vae), jnp.zeros((1, size, size, 3)), seed=2),
    }
    rng = np.random.default_rng(0)
    latents0 = rng.standard_normal((b, f, lat, lat, 4)).astype(np.float32)
    consts = (rng.standard_normal((b, lat, lat, 4)).astype(np.float32),
              (rng.standard_normal((2 * b, 16, ucfg.cross_attention_dim)) * 0.5).astype(np.float32),
              rng.standard_normal((2 * b, ucfg.image_embed_dim)).astype(np.float32))

    jpipe = JPipeline.__new__(JPipeline)
    jpipe.config, jpipe.dtype = jcfg, jnp.float32
    jpipe.pipe_config = JPipelineConfig(num_frames=f, height=size, width=size, num_inference_steps=steps,
                                        dtype="float32", blur_sigma=1.0)
    jpipe.unet, jpipe.vae = JUNet(jcfg.unet), JVAE(jcfg.vae)
    jpipe.schedule = j_make_schedule(jcfg.scheduler)
    forcing = Forcing(monkeypatch)
    forcing.record()
    _, j_step, j_decode, ts, prev, _ = jpipe._build_parts(b, f, size, size, steps, 1.0, 7.5, True, True, 0,
                                                          False, 1)
    jconsts = tuple(jnp.asarray(c) for c in consts)
    carry = (jnp.asarray(latents0), jax.random.PRNGKey(0))
    j_step = jax.jit(j_step)
    for t, tp in zip(ts, prev):
        carry = j_step(params, jconsts, carry, jnp.asarray(t), jnp.asarray(tp))
    want = np.asarray(jax.jit(j_decode)(params, jconsts, carry[0]))
    jax.effects_barrier()

    pcfg = pconfig.PipelineConfig(num_frames=f, height=size, width=size, num_inference_steps=steps,
                                  dtype="float32", blur_sigma=1.0)
    assert pcfg.int8_conv  # the serving default
    mc = pconfig.tiny_test_config()
    pipe = random_pipeline(mc.replace(unet=mc.unet.replace(flash_static_max=0.0, fast_gelu=False)),
                           pcfg, "cpu")
    load_flax_params(pipe.unet, params["unet"])
    load_flax_params(pipe.vae, params["vae"])
    assert pipe.config.unet.int8_conv and pipe.config.vae.int8_decode
    _, step, decode, pts, pprev, _ = pipe._build_parts(b, f, size, size, steps, 1.0, 7.5, True, True)
    pconsts = tuple(T(c) for c in consts)

    def run():
        latents = T(latents0)
        for t, tp in zip(pts, pprev):
            latents = step(pconsts, latents, t, tp)
        return decode(pconsts, latents).numpy().reshape(want.shape)

    with torch.no_grad():
        free = run()
        forcing.force()
        forced = run()
    forcing.check()
    assert maxerr(forced, want) <= 1e-4
    # free-running, flips compound over the steps and the decode
    assert _free_running_ok(free, want, LOOP_FREE_MAX_STEPS)


def test_serving_default_config_builds_and_serves():
    """``I2VAdapterPipeline(cfg, modules, tok)`` with the literal default
    ``PipelineConfig()`` (bf16, int8 convs) on the CPU at the tiny config."""
    mc = pconfig.tiny_test_config()
    pipe = random_pipeline(mc, pconfig.PipelineConfig(), "cpu")
    assert pipe.dtype == torch.bfloat16 and pipe.config.unet.int8_conv
    image = np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    video = pipe("a cat", condition_image=image, num_frames=2, height=32, width=32,
                 num_inference_steps=2, seed=0)
    assert video.shape == (1, 2, 32, 32, 3) and video.dtype == np.uint8


# ---------------------------------------------------------------------------
# the launch derivation
# ---------------------------------------------------------------------------


def test_int8_launch_derivation_matches_the_model(monkeypatch):
    """chip_smoke's int8 sites (stride-1 convs for the conv kernel, stride-2
    ones for K7) equal the int8 convs a tiny UNet evaluation and a tiny
    decode actually make; at SD1.5 width 47 + 3 per evaluation and 31 per
    decode."""
    calls = []
    real = player.int8_conv

    def counting(x, kernel, bias, stride=1, padding=1, absmax=None):
        b, h, w, c = x.shape
        calls.append((stride, h, w, c, kernel.shape[-1]))
        return real(x, kernel, bias, stride, padding, absmax=absmax)

    monkeypatch.setattr(player, "int8_conv", counting)
    mc = pconfig.tiny_test_config()
    ucfg = mc.unet.replace(int8_conv=True)
    unet = VideoUNet(ucfg, device="cpu")
    with torch.no_grad():
        unet(torch.zeros(1, 2, 8, 8, 4), 1.0, torch.zeros(1, 7, ucfg.cross_attention_dim),
             torch.zeros(1, ucfg.image_embed_dim))
    counted = {}
    for stride, h, w, c, co in calls:
        key = (stride, h, c, co)
        counted[key] = counted.get(key, 0) + 1
    derived = {(1, h, c, co): n for h, c, co, n in chip_smoke.int8_unet_sites(ucfg, 8)}
    for h, c, co, n in chip_smoke.int8_downsample_sites(ucfg, 8):
        derived[(2, h, c, co)] = derived.get((2, h, c, co), 0) + n
    assert counted == derived
    calls.clear()
    vae = AutoencoderKL(mc.vae.replace(int8_decode=True), device="cpu")
    with torch.no_grad():
        vae.decode(torch.zeros(1, 4, 4, 4))
    counted = {}
    for stride, h, w, c, co in calls:
        counted[(h, c, co)] = counted.get((h, c, co), 0) + 1
    assert counted == {(h, c, co): n for h, c, co, n in chip_smoke.int8_decoder_sites(mc.vae, 4)}
    full = pconfig.I2VModelConfig()
    assert sum(n for *_, n in chip_smoke.int8_unet_sites(full.unet.replace(int8_conv=True), 64)) == 47
    assert sum(n for *_, n in chip_smoke.int8_downsample_sites(full.unet.replace(int8_conv=True), 64)) == 3
    assert sum(n for *_, n in chip_smoke.int8_decoder_sites(full.vae, 64)) == 31
