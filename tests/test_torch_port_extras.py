"""The serving extras of the port against the JAX package, at the tiny config
on the CPU, fp32, exact convs unless a case says int8.

Modules (the JAX side under ``jax.jit`` where a UNet is involved, each
compiled once per module):

* ``CLIPVisionEncoder(output_hidden_state=True)``'s penultimate states;
  ``PerceiverAttention``, the plus resampler and the full_face projection;
  the tiny UNet with the plus head and FreeU, and with the full_face head
  (1e-4 of max);
* ``return_encoder`` / ``cached_encoder``: the down-path features, a cached
  evaluation at another timestep against the JAX cached evaluation, and a
  cached evaluation fed its own features equal to the full one (exactly);
* ``fourier_filter`` / ``apply_freeu`` at odd and even H, W (1e-5);
  ``temporal_windows`` / ``window_weights`` (equal) and ``tiled_unet_call``
  (plain, collecting and reading caches; 1e-6);
* ``decode_sliced`` / ``decode_tiled``, exact (1e-4) and int8
  (teacher-forced: one activation scale per slice or tile, as in JAX);
* ``prep``'s plus / full_face branch (penultimate states, the zero-image
  unconditional branch) and its ``init_latents``.

The denoise loop.  The JAX package's own stepwise sampler
(``_stepwise_sampler``, its loop, pairing, CFG count and callback) runs its
own parts, its prep replaced by the consts and initial latents both sides
are fed; the port's ``_denoise`` runs the port's parts on the same.  In the
option cases the JAX parts' UNet evaluations are the port UNet's, reached
through ``jax.pure_callback`` (the module cases above hold that UNet against
the JAX one), so that each case costs no UNet compile and what is compared
is everything around the UNet: the encoder-cache pairing and its per-chunk
and per-window caches, the CFG count (half to even), the cond-only half,
the windows and their blend, the chunking and the callback's ``(i, t)``.
Final latents agree to 1e-4 of max and PSNR > 35 dB.

``__call__``: the arrays it hands the sampler (``num_videos_per_prompt``'s
interleaved repeat, ``latents``, the auto ``unet_chunk`` / ``decode_slice``)
equal the JAX ``__call__``'s; the refusals and ``ValueError``s.
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
from i2v_adapter_tpu.models import CLIPTextEncoder as JText
from i2v_adapter_tpu.models import CLIPVisionEncoder as JVision
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.models import unet_video as junet_mod
from i2v_adapter_tpu.models.vae import decode_sliced as j_decode_sliced
from i2v_adapter_tpu.models.vae import decode_tiled as j_decode_tiled
from i2v_adapter_tpu.ops import freeu as jfreeu
from i2v_adapter_tpu.pipelines import tiling as jtiling
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu.utils.tokenizer import make_test_tokenizer as j_make_test_tokenizer
from i2v_adapter_tpu_torch.config import I2VModelConfig, PipelineConfig, tiny_test_config
from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPVisionEncoder, VideoUNet
from i2v_adapter_tpu_torch.models import unet_video as punet_mod
from i2v_adapter_tpu_torch.models.vae import decode_sliced, decode_tiled
from i2v_adapter_tpu_torch.ops import freeu as pfreeu
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.pipelines import tiling as ptiling
from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import cfg_steps
from i2v_adapter_tpu_torch.utils.convert import load_flax_params
from i2v_adapter_tpu_torch.utils.tokenizer import make_test_tokenizer
from tests.test_torch_port_int8 import _check
from tests.torch_port_common import maxerr, one_torch_thread, psnr, random_params  # noqa: F401

T = torch.from_numpy
EXACT = dict(flash_attention=False, fast_gelu=False, flash_static_max=0.0)
LAT = 8  # latent side: 16 px frames at the tiny VAE's factor 2
TOL = 1e-4
# the IP heads' geometry at the tiny config (image encoder hidden size 16)
HEADS = {"plus": dict(ip_variant="plus", ip_num_tokens=6, ip_hidden_dim=16, ip_resampler_dim=12,
                      ip_resampler_depth=2, ip_resampler_heads=2),
         "full_face": dict(ip_variant="full_face", ip_num_tokens=5, ip_hidden_dim=16)}
FREEU = (0.9, 0.2, 1.2, 1.4)


def _jcfg(**unet):
    cfg = j_tiny()
    return cfg.replace(unet=cfg.unet.replace(**EXACT, **unet))


def _pcfg(**unet):
    cfg = tiny_test_config()
    return cfg.replace(unet=cfg.unet.replace(flash_static_max=0.0, fast_gelu=False, **unet))


def _head_params(variant, seed):
    """A Flax tree of the ``variant`` IP head alone (cheap: the head's own
    init), to replace the standard head of a UNet tree."""
    ucfg = _jcfg(**HEADS[variant]).unet
    hidden = jnp.zeros((1, ucfg.ip_num_tokens if variant == "full_face" else 5, ucfg.ip_hidden_dim))
    if variant == "plus":
        head = junet_mod.IPAdapterPlusResampler(
            num_queries=ucfg.ip_num_tokens, dim=ucfg.ip_resampler_dim, depth=ucfg.ip_resampler_depth,
            heads=ucfg.ip_resampler_heads, cross_attention_dim=ucfg.cross_attention_dim)
    else:
        head = junet_mod.IPAdapterFullFaceProjection(cross_attention_dim=ucfg.cross_attention_dim)
    return head, random_params(head, hidden, seed=seed)["params"]


@pytest.fixture(scope="module")
def models():
    jcfg = _jcfg()
    ucfg, size = jcfg.unet, LAT * jcfg.vae.spatial_scale_factor
    isz = jcfg.image_encoder.image_size
    unet = random_params(JUNet(ucfg), jnp.zeros((1, 2, LAT, LAT, 4)), jnp.zeros((1,)),
                         jnp.zeros((1, 7, ucfg.cross_attention_dim)), jnp.zeros((1, ucfg.image_embed_dim)),
                         seed=1, enable_cross_frame_attn=True)
    params = {"unet": unet,
              "vae": random_params(JVAE(jcfg.vae), jnp.zeros((1, size, size, 3)), seed=2),
              "text_encoder": random_params(JText(jcfg.text_encoder), jnp.zeros((1, 16), jnp.int32), seed=3),
              "image_encoder": random_params(JVision(jcfg.image_encoder), jnp.zeros((1, isz, isz, 3)), seed=4)}
    heads = {}
    for i, variant in enumerate(HEADS):
        head, tree = _head_params(variant, 20 + i)
        inner = {k: v for k, v in unet["params"].items() if k != "encoder_hid_proj"}
        heads[variant] = {"module": head, "head": tree, "unet": {"params": {**inner, "encoder_hid_proj": tree}}}
    # the JAX vision tower once, on an IP image and a zero image
    clip = np.random.default_rng(1).standard_normal((1, isz, isz, 3)).astype(np.float32)
    both = jnp.asarray(np.concatenate([clip, np.zeros_like(clip)]))
    vision = jax.jit(lambda p, x: JVision(jcfg.image_encoder).apply(p, x, output_hidden_state=True))
    return {"jcfg": jcfg, "params": params, "heads": heads, "size": size, "clip": clip,
            "vision": vision(params["image_encoder"], both)}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_clip_penultimate_matches_jax(models):
    jcfg, params = models["jcfg"], models["params"]["image_encoder"]
    isz = jcfg.image_encoder.image_size
    x = np.concatenate([models["clip"], np.zeros_like(models["clip"])])
    want_emb, want_hidden = models["vision"]
    port = load_flax_params(CLIPVisionEncoder(tiny_test_config().image_encoder, device="cpu"), params)
    with torch.no_grad():
        emb, hidden = port(T(x), output_hidden_state=True)
        plain = port(T(x))
    assert hidden.shape == want_hidden.shape == (2, (isz // 14) ** 2 + 1, 16)
    assert maxerr(hidden.numpy(), want_hidden) < TOL and maxerr(emb.numpy(), want_emb) < TOL
    assert torch.equal(plain, emb)


@pytest.mark.parametrize("kind", ["perceiver", "plus", "full_face"])
def test_ip_heads_match_jax(models, kind):
    rng = np.random.default_rng(len(kind))
    if kind == "perceiver":
        jm = junet_mod.PerceiverAttention(heads=2)
        args = (rng.standard_normal((2, 5, 12)).astype(np.float32), rng.standard_normal((2, 6, 12)).astype(np.float32))
        params = random_params(jm, *(jnp.asarray(a) for a in args), seed=5)
        pm = punet_mod.PerceiverAttention(12, 2)
    else:
        jm, tree = models["heads"][kind]["module"], models["heads"][kind]["head"]
        params = {"params": tree}
        n = HEADS[kind]["ip_num_tokens"] if kind == "full_face" else 5
        args = (rng.standard_normal((2, n, 16)).astype(np.float32),)
        pm = punet_mod._image_projection(_pcfg(**HEADS[kind]).unet)
    want = jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = load_flax_params(pm, params)(*(T(a) for a in args))
    assert got.shape == want.shape
    assert maxerr(got.numpy(), want) < TOL


def _unet_inputs(rng, ucfg, f=2, img_shape=None):
    x = rng.standard_normal((2, f, LAT, LAT, 4)).astype(np.float32)
    txt = (rng.standard_normal((2, 7, ucfg.cross_attention_dim)) * 0.5).astype(np.float32)
    img = rng.standard_normal(img_shape or (2, ucfg.image_embed_dim)).astype(np.float32)
    return x, txt, img


@pytest.fixture(scope="module")
def full_face_cached(models):
    """One jit of the JAX full_face UNet: the full evaluation at t1 with its
    down-path features, and a cached evaluation from them at t2."""
    ucfg = _jcfg(**HEADS["full_face"]).unet
    rng = np.random.default_rng(9)
    x, txt, img = _unet_inputs(rng, ucfg, img_shape=(2, ucfg.ip_num_tokens, ucfg.ip_hidden_dim))
    t1, t2 = np.array([421.0, 421.0], np.float32), np.array([381.0, 381.0], np.float32)
    params = models["heads"]["full_face"]["unet"]

    def fn(p, x, t1, t2, txt, img):
        m = JUNet(ucfg)
        out, enc = m.apply(p, x, t1, txt, img, enable_cross_frame_attn=True, return_encoder=True)
        return out, enc, m.apply(p, x, t2, txt, img, enable_cross_frame_attn=True, cached_encoder=enc)

    want = jax.jit(fn)(params, *(jnp.asarray(a) for a in (x, t1, t2, txt, img)))
    port = load_flax_params(VideoUNet(_pcfg(**HEADS["full_face"]).unet, device="cpu"), params)
    return {"inputs": (x, t1, t2, txt, img), "want": want, "port": port}


@pytest.mark.parametrize("variant", ["plus_freeu", "full_face"])
def test_unet_ip_variants_match_jax(models, full_face_cached, variant):
    if variant == "full_face":
        x, t1, _, txt, img = full_face_cached["inputs"]
        pm, want = full_face_cached["port"], full_face_cached["want"][0]
    else:
        ucfg = _jcfg(**HEADS["plus"], freeu=FREEU).unet
        x, txt, img = _unet_inputs(np.random.default_rng(8), ucfg, img_shape=(2, 5, ucfg.ip_hidden_dim))
        t1 = np.array([421.0, 421.0], np.float32)
        params = models["heads"]["plus"]["unet"]
        want = jax.jit(lambda p, *a: JUNet(ucfg).apply(p, *a, enable_cross_frame_attn=True))(
            params, *(jnp.asarray(a) for a in (x, t1, txt, img)))
        pm = load_flax_params(VideoUNet(_pcfg(**HEADS["plus"]).unet, device="cpu"), params)
        pm.set_freeu(pfreeu.FreeUParams(*FREEU))
    with torch.no_grad():
        got = pm(T(x), T(t1), T(txt), T(img), enable_cross_frame_attn=True)
    assert got.shape == want.shape
    assert maxerr(got.numpy(), want) < TOL


def test_unet_encoder_cache_matches_jax(full_face_cached):
    x, t1, t2, txt, img = (T(a) for a in full_face_cached["inputs"])
    want_full, (want_x, want_skips), want_cached = full_face_cached["want"]
    pm = full_face_cached["port"]
    with torch.no_grad():
        full, (enc_x, enc_skips) = pm(x, t1, txt, img, enable_cross_frame_attn=True, return_encoder=True)
        cached = pm(x, t2, txt, img, enable_cross_frame_attn=True, cached_encoder=(enc_x, enc_skips))
        own = pm(x, t1, txt, img, enable_cross_frame_attn=True, cached_encoder=(enc_x, enc_skips))
        plain = pm(x, t1, txt, img, enable_cross_frame_attn=True)
    assert len(enc_skips) == len(want_skips)
    assert maxerr(enc_x.numpy(), want_x) < TOL
    for a, b in zip(enc_skips, want_skips):
        assert a.shape == b.shape and maxerr(a.numpy(), b) < TOL
    assert maxerr(full.numpy(), want_full) < TOL and maxerr(cached.numpy(), want_cached) < TOL
    # the split is exact: fed its own features, a cached evaluation is the full one
    assert torch.equal(own, full) and torch.equal(plain, full)
    assert maxerr(cached.numpy(), full.numpy()) > 1e-3  # another timestep, another output


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9)], ids=["even", "odd"])
def test_fourier_filter_and_freeu_match_jax(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((2, h, w, 6)).astype(np.float32)
    skip = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    for threshold, scale in ((1, 0.2), (2, 0.9)):
        want = jax.jit(jfreeu.fourier_filter, static_argnums=(1, 2))(jnp.asarray(x), threshold, scale)
        assert maxerr(pfreeu.fourier_filter(T(x), threshold, scale).numpy(), want) < 1e-5
    params = pfreeu.FreeUParams(*FREEU)
    for stage in (0, 1, 2):
        jh, js = jax.jit(jfreeu.apply_freeu, static_argnums=(0, 3))(stage, jnp.asarray(x), jnp.asarray(skip),
                                                                     jfreeu.FreeUParams(*FREEU))
        ph, ps = pfreeu.apply_freeu(stage, T(x), T(skip), params)
        assert maxerr(ph.numpy(), jh) < 1e-5 and maxerr(ps.numpy(), js) < 1e-5


def test_temporal_windows_and_weights_match_jax():
    for frames, window, stride in ((12, 7, 6), (48, 16, 12), (16, 16, 12), (33, 15, 14), (10, 7, 1)):
        assert ptiling.temporal_windows(frames, window, stride) == jtiling.temporal_windows(frames, window, stride)
    for window, overlap in ((7, 1), (16, 4), (5, 0)):
        np.testing.assert_array_equal(ptiling.window_weights(window, overlap),
                                      jtiling.window_weights(window, overlap))


@pytest.mark.parametrize("mode", ["plain", "collect", "cached"])
def test_tiled_unet_call_matches_jax(mode):
    """The blend on a stand-in evaluation that mixes frames (a per-window
    frame mean), so anchoring and window placement show."""
    lat = np.random.default_rng(3).standard_normal((2, 12, 3, 3, 4)).astype(np.float32)

    def make(xp):
        def apply(x, anchored, **kw):
            pred = x * 2.0 + x.mean(1, keepdims=True) + (1.0 if anchored else 0.0)
            if "cache" not in kw:
                return pred
            if kw["cache"] is None:
                return pred, x[:, :1] * 3.0
            return pred + kw["cache"]
        return apply

    kw = dict(window=7, stride=6)
    j, p = jtiling.tiled_unet_call, ptiling.tiled_unet_call
    if mode == "plain":
        want, got = j(make(jnp), jnp.asarray(lat), **kw), p(make(torch), T(lat), **kw)
    else:
        want, jc = j(make(jnp), jnp.asarray(lat), collect_caches=True, **kw)
        got, pc = p(make(torch), T(lat), collect_caches=True, **kw)
        assert len(jc) == len(pc) == 2
        if mode == "cached":
            want = j(make(jnp), jnp.asarray(lat), caches=jc, **kw)
            got = p(make(torch), T(lat), caches=pc, **kw)
    assert maxerr(got.numpy(), want) < 1e-6


@pytest.mark.parametrize("int8", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("kind", ["sliced", "tiled"])
def test_decode_sliced_and_tiled_match_jax(models, monkeypatch, kind, int8):
    """Each slice or tile is one decoder call on both sides, so under int8
    each takes its own activation scale: the teacher-forced comparison
    holds the port's sites, in order, to the JAX ones."""
    vcfg = models["jcfg"].vae.replace(int8_decode=int8)
    jm, params = JVAE(vcfg), models["params"]["vae"]
    pm = load_flax_params(AutoencoderKL(tiny_test_config().vae.replace(int8_decode=int8), device="cpu"), params)
    dec = lambda p, z: jm.apply(p, z, method=jm.decode)  # noqa: E731
    if kind == "sliced":
        z = np.random.default_rng(4).standard_normal((4, LAT, LAT, 4)).astype(np.float32)
        jax_fn = lambda: jax.jit(lambda p, z: j_decode_sliced(dec, p, z, 2))(params, jnp.asarray(z))  # noqa: E731
        port_fn = lambda: decode_sliced(pm.decode, T(z), 2).numpy()  # noqa: E731
    else:  # 4 tiles exact (both blends), 2 tiles (rows) under int8
        z = np.random.default_rng(5).standard_normal((1, 12, 8 if int8 else 12, 4)).astype(np.float32)
        jax_fn = lambda: jax.jit(lambda p, z: j_decode_tiled(dec, p, z, tile_latent_size=8))(  # noqa: E731
            params, jnp.asarray(z))
        port_fn = lambda: decode_tiled(pm.decode, T(z), tile_latent_size=8).numpy()  # noqa: E731
    if int8:  # two decoder calls (slices or tiles), each with every int8 site
        sites = _check(monkeypatch, jax_fn, port_fn, TOL)
        assert len(sites) == 2 * sum(n for *_, n in chip_smoke.int8_decoder_sites(vcfg, LAT))
    else:
        want = np.asarray(jax_fn())
        with torch.no_grad():
            got = port_fn()
        assert got.shape == want.shape and maxerr(got, want) < TOL
        whole = pm.decode(T(z)).detach().numpy()
        assert got.shape == whole.shape
        if kind == "sliced":
            assert maxerr(got, whole) < 1e-5  # exact convs: slicing changes nothing


def _port_pipe(models, tmp_path, variant="standard", **pipe_kw):
    heads = HEADS.get(variant, {})
    params = dict(models["params"])
    if heads:
        params["unet"] = models["heads"][variant]["unet"]
    pc = PipelineConfig(num_frames=2, height=models["size"], width=models["size"], num_inference_steps=4,
                        blur_sigma=1.0, dtype="float32", int8_conv=False, **pipe_kw)
    return I2VAdapterPipeline(_pcfg(**heads), params, make_test_tokenizer(str(tmp_path)), pc, device="cpu")


@pytest.mark.parametrize("variant", ["plus", "full_face"])
def test_prep_ip_variant_matches_jax(models, tmp_path, variant):
    """The plus / full_face prep: penultimate hidden states of the IP image,
    and of a zero image for the unconditional half."""
    jcfg = models["jcfg"]
    pipe = _port_pipe(models, tmp_path, variant)
    isz, size = jcfg.image_encoder.image_size, models["size"]
    clip = models["clip"]
    cond = np.random.default_rng(7).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    prep = pipe._build_parts(1, 2, size, size, 4, 0.9, 7.5, True, True)[0]
    with torch.no_grad():
        _, (_, _, image_embeds) = prep(pipe.tokenizer(["", "a cat"]), cond, clip,
                                       torch.Generator().manual_seed(0))
    hidden = np.asarray(models["vision"][1])  # [the IP image; a zero image]
    assert image_embeds.shape == (2, (isz // 14) ** 2 + 1, 16)
    assert maxerr(image_embeds.numpy(), np.concatenate([hidden[1:], hidden[:1]])) < TOL


def test_prep_init_latents_on_the_no_condition_path(models, tmp_path):
    pipe, size = _port_pipe(models, tmp_path), models["size"]
    init = np.random.default_rng(8).standard_normal((1, 2, LAT, LAT, 4)).astype(np.float32)
    prep = pipe._build_parts(1, 2, size, size, 4, 0.9, 7.5, True, False)[0]
    clip = np.zeros((1, 28, 28, 3), np.float32)
    with torch.no_grad():
        latents, consts = prep(pipe.tokenizer(["", "a"]), None, clip, None, init_latents=init)
    np.testing.assert_array_equal(latents.numpy(), init)
    assert consts[0] is None


# ---------------------------------------------------------------------------
# the denoise loop
# ---------------------------------------------------------------------------


class PortUNetInJax:
    """The JAX pipeline's ``unet`` whose evaluations are the port UNet's,
    through ``jax.pure_callback`` (so the JAX parts may be jitted)."""

    def __init__(self, module):
        self.m, self.shapes = module, {}

    def _run(self, x, t, txt, img, *enc, cross_frame, return_encoder):
        cached = None if not enc else (T(np.array(enc[0])), tuple(T(np.array(e)) for e in enc[1:]))
        with torch.no_grad():
            out = self.m(T(np.array(x)), T(np.array(t)), T(np.array(txt)), T(np.array(img)),
                         enable_cross_frame_attn=cross_frame, return_encoder=return_encoder,
                         cached_encoder=cached)
        if return_encoder:
            out, (ex, skips) = out
            return out.numpy(), (ex.numpy(), tuple(s.numpy() for s in skips))
        return out.numpy()

    def apply(self, params, x, t, txt, img, *, enable_cross_frame_attn=False, return_encoder=False,
              cached_encoder=None):
        enc = () if cached_encoder is None else (cached_encoder[0], *cached_encoder[1])
        key = (x.shape, txt.shape, img.shape, return_encoder)
        if key not in self.shapes:  # the output shapes from one dry run at this shape
            zeros = [np.zeros(a.shape, np.float32) for a in (x, t, txt, img)]
            dry = self._run(*zeros, cross_frame=False, return_encoder=return_encoder)
            self.shapes[key] = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, np.float32), dry)

        def host(*args):
            return self._run(*args, cross_frame=enable_cross_frame_attn, return_encoder=return_encoder)

        return jax.pure_callback(host, self.shapes[key], x, t.astype(jnp.float32), txt, img, *enc)


def _jax_pipe(jcfg, size, unet, frames):
    pipe = JPipeline.__new__(JPipeline)
    pipe.config, pipe.dtype = jcfg, jnp.float32
    pipe.pipe_config = JPipelineConfig(num_frames=frames, height=size, width=size, num_inference_steps=4,
                                       dtype="float32", blur_sigma=1.0, int8_conv=False)
    pipe.unet, pipe.vae = unet, JVAE(jcfg.vae)
    pipe.schedule = j_make_schedule(jcfg.scheduler)
    pipe.mesh = None
    return pipe


def _loop_inputs(ucfg, b, f, use_cfg, seed):
    rng = np.random.default_rng(seed)
    evals = 2 * b if use_cfg else b
    return (rng.standard_normal((b, f, LAT, LAT, 4)).astype(np.float32),
            (rng.standard_normal((b, LAT, LAT, 4)).astype(np.float32),
             (rng.standard_normal((evals, 16, ucfg.cross_attention_dim)) * 0.5).astype(np.float32),
             rng.standard_normal((evals, ucfg.image_embed_dim)).astype(np.float32)))


def _run_loops(models, tmp_path, monkeypatch, jpipe_unet, *, frames=2, steps=4, batch=1, use_cfg=True,
               encoder_cache=1, cfg_cutoff=1.0, unet_chunk=1, callback_steps=1):
    """The JAX stepwise sampler and the port's ``_denoise`` on the same
    consts and initial latents; returns their final latents and the
    callbacks' ``(i, t)``."""
    jcfg, size = models["jcfg"], models["size"]
    guidance = 7.5 if use_cfg else 1.0
    latents0, consts = _loop_inputs(jcfg.unet, batch, frames, use_cfg, seed=frames + steps + batch)
    jpipe = _jax_pipe(jcfg, size, jpipe_unet, frames)
    real_parts = jpipe._build_parts

    def fed_parts(**kw):  # the JAX prep replaced by the given consts and latents
        _, *rest = real_parts(**kw)
        return ((lambda *a: ((jnp.asarray(latents0), jax.random.PRNGKey(0)),
                             tuple(jnp.asarray(c) for c in consts))), *rest)

    monkeypatch.setattr(jpipe, "_build_parts", fed_parts)
    seen_jax, seen_port = [], []
    run = jpipe._stepwise_sampler(batch, frames, size, size, steps, 1.0, guidance, use_cfg, True, 0, False,
                                  unet_chunk, decode=False, encoder_cache=encoder_cache, cfg_cutoff=cfg_cutoff)
    want = np.asarray(run({"unet": models["params"]["unet"]}, None, None, None, jax.random.PRNGKey(0),
                          callback=lambda i, t, lat: seen_jax.append((i, t)), callback_steps=callback_steps))

    pipe = _port_pipe(models, tmp_path)
    parts = pipe._build_parts(batch, frames, size, size, steps, 1.0, guidance, use_cfg, True, 0, False,
                              unet_chunk)
    cutoff = cfg_cutoff if use_cfg else 1.0
    pipe.last_timings = {}
    with torch.no_grad():
        latents = pipe._denoise(parts, tuple(T(c) for c in consts), T(latents0), encoder_cache,
                                cfg_steps(cutoff, len(parts[3])),
                                callback=lambda i, t, lat: seen_port.append((i, t)), callback_steps=callback_steps)
        latents[:, 0] = T(consts[0])  # the final clamp, as the JAX 'latent' output
    assert len(pipe.last_timings["step_ms"]) == len(parts[3])
    return latents.numpy(), want, seen_port, seen_jax


LOOP_CASES = {
    "encoder_cache_even": dict(encoder_cache=2, steps=4),
    "encoder_cache_odd": dict(encoder_cache=2, steps=3),
    # 5 steps at 0.5: round(2.5) = 2 CFG steps (half to even), then 3 cond-only
    "cfg_cutoff_half": dict(cfg_cutoff=0.5, steps=5, callback_steps=2),
    "cfg_cutoff_zero": dict(cfg_cutoff=0.0, steps=2),
    "tiling": dict(frames=12, steps=2),
    "tiling_encoder_cache": dict(frames=12, steps=2, encoder_cache=2),
    "unet_chunk": dict(unet_chunk=2, steps=2),
    "unet_chunk_encoder_cache": dict(unet_chunk=2, steps=2, encoder_cache=2),
    "batch2_guidance_1": dict(batch=2, use_cfg=False, steps=2, cfg_cutoff=0.5),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_denoise_loop_matches_jax(models, tmp_path, monkeypatch, case):
    kw = LOOP_CASES[case]
    unet = load_flax_params(VideoUNet(_pcfg().unet, device="cpu"), models["params"]["unet"])
    got, want, seen_port, seen_jax = _run_loops(models, tmp_path, monkeypatch, PortUNetInJax(unet), **kw)
    assert got.shape == want.shape
    assert maxerr(got, want) < TOL and psnr(got, want) > 35.0
    assert seen_port == seen_jax and len(seen_port) > 0


def test_cfg_steps_round_half_to_even():
    for n in range(1, 12):
        for cutoff in (0.0, 0.1, 0.25, 0.5, 0.7, 1.0):
            assert cfg_steps(cutoff, n) == (n if cutoff >= 1.0 else int(round(cutoff * n)))
    assert [cfg_steps(0.5, n) for n in (1, 3, 5)] == [0, 2, 2]


# ---------------------------------------------------------------------------
# __call__
# ---------------------------------------------------------------------------


CALL_CASES = {
    "num_videos_per_prompt": dict(prompt=["a cat", "a dog"], num_videos_per_prompt=2, image=True),
    "latents_no_condition": dict(prompt="a cat", latents=True, image=False),
    "latents_with_condition": dict(prompt="a cat", latents=True, image=True),
    "auto_chunk_and_slice": dict(prompt=["a"] * 3, image=True, num_frames=24),
}


@pytest.mark.parametrize("case", sorted(CALL_CASES))
def test_call_hands_the_sampler_what_jax_does(models, tmp_path, monkeypatch, case):
    """What ``__call__`` builds from its arguments (text ids, condition and
    IP images, initial latents, batch, the auto ``unet_chunk`` and
    ``decode_slice``), captured where each package hands it to its sampler."""
    kw = dict(CALL_CASES[case])
    size = models["size"]
    frames = kw.pop("num_frames", 2)
    rng = np.random.default_rng(len(case))
    image = rng.integers(0, 256, (size, size, 3), dtype=np.uint8) if kw.pop("image") else None
    if kw.pop("latents", False):
        kw["latents"] = rng.standard_normal((1, frames, LAT, LAT, 4)).astype(np.float32)
    args = dict(condition_image=image, num_frames=frames, seed=2, output_type="latent", **kw)

    jpipe = _jax_pipe(models["jcfg"], size, None, frames)
    (tmp_path / "j").mkdir()
    jpipe.tokenizer = j_make_test_tokenizer(str(tmp_path / "j"))
    jpipe.params = {}
    seen = {}

    def jax_sampler(*a, **k):
        seen["jax"] = {"sampler": a[:12], "enc": (k["encoder_cache"], k["cfg_cutoff"])}

        def run(params, text_ids, cond, clip, rng, init_latents=None, **cb):
            seen["jax"].update(text_ids=np.asarray(text_ids), cond=np.asarray(cond), clip=np.asarray(clip),
                               init=None if init_latents is None else np.asarray(init_latents))
            return np.zeros((a[0], frames, LAT, LAT, 4), np.float32)
        return run

    if case == "auto_chunk_and_slice":  # auto rules at a tiny threshold: chunk 2; 72 frames > 64: slice 32
        monkeypatch.setattr(I2VAdapterPipeline, "UNET_CHUNK_AUTO_EVAL_TOKENS", 1)
        monkeypatch.setattr(JPipeline, "UNET_CHUNK_AUTO_EVAL_TOKENS", 1)
    monkeypatch.setattr(jpipe, "_stepwise_sampler", jax_sampler)
    jpipe(**args)

    pipe = _port_pipe(models, tmp_path)
    build = pipe._build_parts

    class Captured(Exception):
        pass

    def port_parts(*a):
        seen["port"] = {"sampler": a}
        _, *rest = build(*a)

        def fed(text_ids, cond, clip, gen, init_latents=None):
            seen["port"].update(text_ids=np.asarray(text_ids), cond=np.asarray(cond), clip=np.asarray(clip),
                                init=init_latents)
            raise Captured  # what the sampler is handed is all this case reads
        return (fed, *rest)

    monkeypatch.setattr(pipe, "_build_parts", port_parts)
    with pytest.raises(Captured):
        pipe(**args)
    j, p = seen["jax"], seen["port"]
    assert p["sampler"] == tuple(j["sampler"])
    for k in ("text_ids", "cond", "clip"):
        np.testing.assert_array_equal(p[k], j[k])
    assert (p["init"] is None) == (j["init"] is None)
    if p["init"] is not None:
        np.testing.assert_array_equal(p["init"], j["init"])
    if case == "auto_chunk_and_slice":
        assert p["sampler"][9:12] == (32, False, 2)


# (call arguments, error, message, a budget set low for the case)
REFUSALS = {
    "encoder_cache_with_cfg_cutoff": (dict(encoder_cache=2, cfg_cutoff=0.5), ValueError, "not composed", None),
    "memory_envelope": (dict(), ValueError, "memory envelope", "MAX_EVAL_TOKENS"),
    "encoder_cache_budget": (dict(encoder_cache=2), ValueError, "cache budget", "MAX_ENC_CACHE_BYTES"),
    "decode_envelope": (dict(output_type="np"), ValueError, "decode envelope", "MAX_DECODE_TOKENS"),
    "callback_steps": (dict(callback=print, callback_steps=0), ValueError, "callback_steps", None),
    "callback_with_scan": (dict(callback=print, dispatch="scan"), ValueError, "stepwise", None),
    "scan": (dict(dispatch="scan"), None, None, None),  # served now, equal to the stepwise loop
    "num_videos_per_prompt": (dict(num_videos_per_prompt=0), ValueError, "num_videos_per_prompt", None),
    "latents_shape": (dict(latents=np.zeros((1, 1, LAT, LAT, 4), np.float32)), ValueError, "latents shape", None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_call_refusals(models, tmp_path, monkeypatch, case):
    kwargs, error, match, budget = REFUSALS[case]
    pipe = _port_pipe(models, tmp_path)
    image = None if case == "latents_shape" else np.zeros((models["size"],) * 2 + (3,), np.uint8)
    if budget:
        monkeypatch.setattr(I2VAdapterPipeline, budget, 1)
    if error is None:  # a request once refused, now served
        got = pipe("a", condition_image=image, **{"output_type": "latent", **kwargs})
        assert pipe.last_dispatch["dispatch"] == kwargs["dispatch"]
        want = pipe("a", condition_image=image, output_type="latent", dispatch="stepwise")
        np.testing.assert_array_equal(got, want)
        return
    with pytest.raises(error, match=match):
        pipe("a", condition_image=image, **{"output_type": "latent", **kwargs})


def test_memory_unsafe_bypasses_both_budgets(models, tmp_path, monkeypatch):
    """``memory_unsafe=True`` skips the envelopes (the UNet's and the
    decode's) and the encoder-cache budget, each set low here."""
    pipe = _port_pipe(models, tmp_path)
    image = np.zeros((models["size"],) * 2 + (3,), np.uint8)
    for budget, kw in (("MAX_EVAL_TOKENS", dict()), ("MAX_ENC_CACHE_BYTES", dict(encoder_cache=2)),
                       ("MAX_DECODE_TOKENS", dict(output_type="float"))):
        with monkeypatch.context() as m:
            m.setattr(I2VAdapterPipeline, budget, 1)
            call = dict(condition_image=image, num_inference_steps=2, **{"output_type": "latent", **kw})
            with pytest.raises(ValueError):
                pipe("a", **call)
            assert np.isfinite(pipe("a", memory_unsafe=True, **call)).all()


# ---------------------------------------------------------------------------
# chip_smoke's launch derivation for the new evaluations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["cached", "full_face_ip_tokens", "cached_int8"])
def test_launch_derivation_of_new_evaluations(monkeypatch, case):
    """chip_smoke's counts for a cached evaluation (mid and up only) and for
    an IP head of >= 128 tokens (the IP attention through K1 at every site)
    equal the wrapper calls of a tiny UNet evaluation; at SD1.5 width a
    full_face evaluation launches K1 46 times, a cached one K1 and K2 18
    times and the int8 conv 31 (and the weight quantiser none: the weights
    are quantised once per load)."""
    from i2v_adapter_tpu_torch.models import layers as player
    from i2v_adapter_tpu_torch.ops import attention as A

    calls = {"flash": 0, "temporal": 0, "int8": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(A, "flash_attention", counting("flash", A.flash_attention))
    monkeypatch.setattr(A, "temporal_attention_cs", counting("temporal", A.temporal_attention_cs))
    monkeypatch.setattr(player, "int8_conv", counting("int8", player.int8_conv))
    tokens = 130 if case == "full_face_ip_tokens" else 0
    ucfg = tiny_test_config().unet.replace(int8_conv=case == "cached_int8")
    if tokens:
        ucfg = ucfg.replace(ip_variant="full_face", ip_num_tokens=tokens, ip_hidden_dim=8)
    unet = VideoUNet(ucfg, device="cpu")
    img = torch.zeros(2, tokens, 8) if tokens else torch.zeros(2, 8)
    args = (torch.zeros(2, 3, 16, 16, 4), 10.0, torch.zeros(2, 5, 16), img)
    with torch.no_grad():
        enc = unet(*args, enable_cross_frame_attn=True, return_encoder=True)[1] if case != "full_face_ip_tokens" \
            else None
        calls.update(flash=0, temporal=0, int8=0)
        unet(*args, enable_cross_frame_attn=True, cached_encoder=enc)
    cached = enc is not None
    assert (calls["flash"], calls["temporal"]) == chip_smoke.launches_per_unet_eval(
        ucfg, 16, True, ip_tokens=tokens, cached=cached)
    if ucfg.int8_conv:
        derived = chip_smoke.int8_launches(tiny_test_config(), 16, cached=cached)["per_eval"]
        assert calls["int8"] == derived["int8_conv3x3_kernel"] + derived["int8_matmul"]
    full = I2VModelConfig()
    assert chip_smoke.launches_per_unet_eval(full.unet, 64, True, ip_tokens=257) == (46, 30)
    assert chip_smoke.launches_per_unet_eval(full.unet, 64, True, cached=True) == (18, 18)
    assert chip_smoke.int8_launches(full, 64, cached=True)["per_eval"] == {
        "int8_conv3x3_kernel": 31, "int8_matmul": 0, "quantize_weights": 0}
