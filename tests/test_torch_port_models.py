"""PyTorch port vs the JAX package: every module of the serving path at the
tiny config, fp32, relative max error 1e-4.

The JAX side runs the exact configuration (flash_attention=False,
fast_gelu=False, flash_static_max=0.0); parameters come from numpy seeds
and reach the port through ``load_flax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.config import tiny_test_config as j_tiny
from i2v_adapter_tpu.models import AutoencoderKL as JVAE
from i2v_adapter_tpu.models import CLIPTextEncoder as JText
from i2v_adapter_tpu.models import CLIPVisionEncoder as JVision
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.models.attention import SpatialTransformer as JSpatial
from i2v_adapter_tpu.models.layers import ResnetBlock2D as JResnet
from i2v_adapter_tpu.models.layers import timestep_embedding as j_temb
from i2v_adapter_tpu.models.temporal import TemporalTransformer as JTemporal
from i2v_adapter_tpu_torch.config import tiny_test_config
from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
from i2v_adapter_tpu_torch.models.attention import SpatialTransformer
from i2v_adapter_tpu_torch.models.layers import ResnetBlock2D, timestep_embedding
from i2v_adapter_tpu_torch.models.temporal import TemporalTransformer
from i2v_adapter_tpu_torch.utils.convert import load_flax_params
from tests.torch_port_common import maxerr, one_torch_thread, random_params  # noqa: F401

TOL = 1e-4
EXACT = dict(flash_attention=False, fast_gelu=False, flash_static_max=0.0)
CPU = "cpu"


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _run(torch_module, params, *args, **kwargs):
    load_flax_params(torch_module, params)
    with torch.no_grad():
        return torch_module(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in args], **kwargs).numpy()


def test_timestep_embedding_matches():
    t = np.array([0.0, 1.0, 421.0, 999.0], np.float32)
    want = j_temb(jnp.asarray(t), 33)
    got = timestep_embedding(torch.from_numpy(t), 33)
    assert maxerr(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
def test_resnet_block(cin, cout):
    rng = np.random.default_rng(cin + cout)
    x, temb = _np(rng, 2, 8, 8, cin), _np(rng, 2, 64)
    jm = JResnet(out_channels=cout, groups=8)
    params = random_params(jm, jnp.asarray(x), jnp.asarray(temb), seed=1)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(temb))
    got = _run(ResnetBlock2D(cin, cout, 64, groups=8), params, x, torch.from_numpy(temb))
    assert maxerr(got, want) < TOL


@pytest.mark.parametrize("cross_frame", [True, False])
def test_spatial_transformer_with_ip(cross_frame):
    """attn1 + cross-frame adapter (kv_repeat = frames) + text/IP attn2."""
    rng = np.random.default_rng(2)
    f = 3
    x, ctx = _np(rng, 2 * f, 12, 12, 32), _np(rng, 2 * f, 7 + 4, 16, scale=0.5)
    jm = JSpatial(heads=2, dim_head=16, ip_num_tokens=4, groups=8, attn_impl="xla")
    params = random_params(jm, jnp.asarray(x), jnp.asarray(ctx), seed=3,
                           enable_cross_frame_attn=True, num_frames=f)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(ctx),
                    enable_cross_frame_attn=cross_frame, num_frames=f)
    pm = SpatialTransformer(32, heads=2, dim_head=16, context_dim=16, ip_num_tokens=4, groups=8)
    got = _run(pm, params, x, torch.from_numpy(ctx), enable_cross_frame_attn=cross_frame, num_frames=f)
    assert maxerr(got, want) < TOL


def test_temporal_transformer():
    """GroupNorm over (F, H, W) per clip, PE after norm1/norm2, S >= 128
    so the port's auto dispatch reaches the kernel wrapper."""
    rng = np.random.default_rng(4)
    f = 4
    x = _np(rng, 2 * f, 12, 12, 32)
    jm = JTemporal(heads=2, dim_head=16, max_seq_length=8, groups=8, attn_impl="xla")
    params = random_params(jm, jnp.asarray(x), seed=5, num_frames=f)
    want = jm.apply(params, jnp.asarray(x), num_frames=f)
    got = _run(TemporalTransformer(32, 2, 16, max_seq_length=8, groups=8), params, x, num_frames=f)
    assert maxerr(got, want) < TOL


def test_temporal_max_seq_length_refused():
    pm = TemporalTransformer(32, 2, 16, max_seq_length=2, groups=8)
    with pytest.raises(ValueError, match="exceeds"):
        pm(torch.zeros(3, 4, 4, 32), num_frames=3)


def _unet_inputs(rng, b, f, lat, ucfg):
    return (_np(rng, b, f, lat, lat, 4), _np(rng, b, 7, ucfg.cross_attention_dim, scale=0.5),
            _np(rng, b, ucfg.image_embed_dim))


@pytest.fixture(scope="module")
def unet_params():
    ucfg = j_tiny().unet.replace(**EXACT)
    x, txt, img = _unet_inputs(np.random.default_rng(6), 2, 2, 16, ucfg)
    return random_params(
        JUNet(ucfg), jnp.asarray(x), jnp.zeros((2,)), jnp.asarray(txt), jnp.asarray(img),
        seed=7, enable_cross_frame_attn=True,
    )


@pytest.mark.parametrize("fast_gelu", [False, True])
def test_video_unet_full_eval(unet_params, fast_gelu):
    """One full evaluation: CFG batch of 2 clips, 2 frames, IP tokens,
    cross-frame on.  The port runs its auto dispatch (flash / temporal
    wrappers on the 256-token sites, plain math below)."""
    rng = np.random.default_rng(8)
    ucfg = j_tiny().unet.replace(**{**EXACT, "fast_gelu": fast_gelu})
    x, txt, img = _unet_inputs(rng, 2, 2, 16, ucfg)
    t = np.array([421.0, 421.0], np.float32)
    # one jit compile of the tiny UNet is ~5x cheaper than op-by-op dispatch
    apply = jax.jit(lambda p, *a: JUNet(ucfg).apply(p, *a, enable_cross_frame_attn=True))
    want = apply(unet_params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(txt), jnp.asarray(img))
    pcfg = tiny_test_config().unet.replace(flash_static_max=0.0, fast_gelu=fast_gelu)
    pm = VideoUNet(pcfg, device=CPU)
    got = _run(pm, unet_params, x, torch.from_numpy(t), txt, img, enable_cross_frame_attn=True)
    assert got.shape == (2, 2, 16, 16, 4)
    assert maxerr(got, want) < TOL


def test_video_unet_refuses_unported_options():
    """No UNet option is refused any more: FreeU builds with the same
    parameters, the plus and full_face IP heads with their own head in place
    of the standard one (their parity with JAX is in
    tests/test_torch_port_extras.py)."""
    plain = list(VideoUNet(tiny_test_config().unet, device=CPU).state_dict())
    freeu = VideoUNet(tiny_test_config().unet.replace(freeu=(0.9, 0.2, 1.2, 1.4)), device=CPU)
    assert list(freeu.state_dict()) == plain
    body = [n for n in plain if not n.startswith("encoder_hid_proj.")]
    for variant, leaf in (("plus", "encoder_hid_proj.layers_0_attn.to_kv.weight"),
                          ("full_face", "encoder_hid_proj.proj_3.weight")):
        names = list(VideoUNet(tiny_test_config().unet.replace(ip_variant=variant), device=CPU).state_dict())
        assert [n for n in names if not n.startswith("encoder_hid_proj.")] == body and leaf in names
    # the fused-conv and int8 configurations are ported: they build, with the
    # same parameters
    fused = VideoUNet(tiny_test_config().unet.replace(conv_impl="pallas"), device=CPU)
    assert list(fused.state_dict()) == plain
    assert all(m.conv_impl == "pallas" for m in fused.modules() if isinstance(m, ResnetBlock2D))
    int8 = VideoUNet(tiny_test_config().unet.replace(int8_conv=True), device=CPU)
    assert list(int8.state_dict()) == plain
    assert all(m.int8 for m in int8.modules() if isinstance(m, ResnetBlock2D))


@pytest.fixture(scope="module")
def vae_setup():
    vcfg = j_tiny().vae
    x = _np(np.random.default_rng(9), 2, 32, 32, 3)
    jm = JVAE(vcfg)
    params = random_params(jm, jnp.asarray(x), seed=10)
    pm = load_flax_params(AutoencoderKL(tiny_test_config().vae, device=CPU), params)
    return jm, params, pm, x


def test_vae_encode_moments(vae_setup):
    jm, params, pm, x = vae_setup
    jmean, jlogvar = jm.apply(params, jnp.asarray(x), method=jm.encode_moments)
    with torch.no_grad():
        mean, logvar = pm.encode_moments(torch.from_numpy(x))
    assert maxerr(mean.numpy(), jmean) < TOL
    assert maxerr(logvar.numpy(), jlogvar) < TOL


def test_vae_decode(vae_setup):
    jm, params, pm, _ = vae_setup
    z = _np(np.random.default_rng(11), 2, 16, 16, 4)
    want = jm.apply(params, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        got = pm.decode(torch.from_numpy(z)).numpy()
    assert got.shape == (2, 32, 32, 3)
    assert maxerr(got, want) < TOL


@pytest.mark.parametrize("clip_skip", [0, 1])
def test_clip_text_encoder(clip_skip):
    cfg = j_tiny().text_encoder
    ids = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jm = JText(cfg)
    params = random_params(jm, jnp.asarray(ids), seed=13)
    want = jm.apply(params, jnp.asarray(ids), clip_skip=clip_skip)
    got = _run(CLIPTextEncoder(tiny_test_config().text_encoder, device=CPU), params,
               torch.from_numpy(ids), clip_skip=clip_skip)
    assert maxerr(got, want) < TOL


def test_clip_vision_encoder():
    cfg = j_tiny().image_encoder
    px = _np(np.random.default_rng(14), 2, 28, 28, 3)
    jm = JVision(cfg)
    params = random_params(jm, jnp.asarray(px), seed=15)
    want = jm.apply(params, jnp.asarray(px))
    got = _run(CLIPVisionEncoder(tiny_test_config().image_encoder, device=CPU), params, px)
    assert got.shape == (2, cfg.projection_dim)
    assert maxerr(got, want) < TOL
