"""Stable Video Diffusion (img2vid-xt) in the port against the benchmark's
plain fp32 reference (``portbench/reference/svd.py``), at tiny sizes on the
CPU with seeded random weights (``portbench.weights``: one set loaded into
both): every new block, the UNet evaluation, the temporal decode (a chunk
of one frame too), the Euler sampler against its closed form, a whole
request, its spans and the CLI; and the control, the reference with float8
operands, failing the tolerance that the port in bf16 passes.  No JAX.

Tolerances, with their reasons:

* ``FP32_RTOL`` 1e-4 of the largest magnitude, for the port in fp32 against
  the reference in fp32: the two sum in different orders (the port's
  (3, 1, 1) convolution as three matmuls, its GroupNorm's fused
  statistics, the one-key attention as its value), each a few fp32 ulps,
  compounded over the tiny UNet's blocks.
* ``BF16_RTOL`` 0.05, for the port in bf16 (the configuration's dtype)
  against the fp32 reference on one UNet evaluation: bf16 keeps 8 bits, so
  each operand is off by up to 2^-9 and the blocks compound it; sound runs
  read about 0.01.  The float8 control (3 mantissa bits) reads well above.
"""

import math

import numpy as np
import pytest
import torch

from i2v_adapter_tpu_torch.config import SVDPipelineConfig, tiny_svd_config
from i2v_adapter_tpu_torch.models import svd as M
from i2v_adapter_tpu_torch.models.clip import CLIPVisionEncoder
from i2v_adapter_tpu_torch.ops.temporal_conv import temporal_conv3, temporal_conv3_plain
from i2v_adapter_tpu_torch.pipelines import StableVideoDiffusionPipeline
from i2v_adapter_tpu_torch.pipelines import cli
from i2v_adapter_tpu_torch.schedulers import euler_sigmas, euler_step, init_noise_sigma
from i2v_adapter_tpu_torch.utils import tracing
from portbench import weights as W
from portbench.reference import svd as R
from portbench.reference.lower import Lowered
from tests.torch_port_common import one_torch_thread  # noqa: F401

FP32_RTOL = 1e-4
BF16_RTOL = 0.05
CFG = tiny_svd_config()
CFG_DICT = CFG.to_dict()
FRAMES, H, W_PX = 4, 32, 64


def rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def weights_for(ref_modules: dict, seed: int = 0) -> dict:
    return W.make(W.spec_of(ref_modules, lambda n: torch.float32), seed, "cpu")


def loaded(port: dict, ref: dict, seed: int = 0):
    """Load one seeded set into the port's and the reference's modules
    (every parameter of each must have a weight of its shape)."""
    w = weights_for(ref, seed)
    W.load(ref, w)
    W.load(port, {k: v.clone() for k, v in w.items()})
    return port, ref


def test_temporal_conv_is_conv3d():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, 8, generator=g)
    w, b = torch.randn(4, 8, 3, 1, 1, generator=g), torch.randn(4, generator=g)
    want = temporal_conv3_plain(x, w, b)
    assert rel(temporal_conv3(x, w, b), want) < 1e-6
    conv = R.Conv3(8, 4, R.EXACT)
    conv.weight, conv.bias = torch.nn.Parameter(w), torch.nn.Parameter(b)
    assert rel(conv(x), want) < 1e-6
    assert rel(temporal_conv3(x[:, :1], w, b), temporal_conv3_plain(x[:, :1], w, b)) < 1e-6  # one frame
    assert temporal_conv3.launches == 0  # a CPU tensor launches nothing


def _block_pair(kind: str):
    """(port module, reference module, inputs) of one block at tiny sizes."""
    c, temb, frames = 32, 64, FRAMES
    x = torch.randn(2 * frames, 4, 6, c, generator=torch.Generator().manual_seed(1))
    emb = torch.randn(2 * frames, temb, generator=torch.Generator().manual_seed(2))
    ctx = torch.randn(2, 1, 8, generator=torch.Generator().manual_seed(3)).repeat_interleave(frames, 0)
    if kind == "st_resnet":
        port, ref = M.SpatioTemporalResBlock(16, c, temb, 1e-6, groups=8), R.STResnet(16, c, temb, 1e-6, 8, R.EXACT)
        return port, ref, (x[..., :16], frames, emb), (x[..., :16], frames, emb)
    if kind == "temporal_resnet":
        port, ref = M.TemporalResnetBlock(c, temb, 1e-5, groups=8), R.TemporalResnet(c, temb, 1e-5, 8, R.EXACT)
        return port, ref, (x, frames, emb), (x, frames, emb)
    if kind == "decoder_st_resnet":
        port = M.SpatioTemporalResBlock(c, 16, None, 1e-6, 1e-5, groups=8, switch=True)
        ref = R.STResnet(c, 16, None, 1e-6, 8, R.EXACT, temporal_eps=1e-5, switch=True)
        return port, ref, (x, frames), (x, frames)
    if kind == "transformer":
        port = M.TransformerSpatioTemporalModel(c, 2, 8, groups=8)
        ref = R.STTransformer(c, 2, 8, 8, 1, R.EXACT)
        return port, ref, (x, ctx, frames), (x, ctx, frames)
    if kind == "temporal_block":
        tokens = x.reshape(2, frames, 24, c)
        first = ctx.reshape(2, frames, 1, 8)[:, 0]
        port, ref = M.TemporalBasicTransformerBlock(c, 2, 8), R.TemporalBlock(c, 2, 8, R.EXACT)
        return port, ref, (tokens, first), (tokens, first)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["st_resnet", "temporal_resnet", "decoder_st_resnet", "transformer",
                                  "temporal_block"])
def test_block_matches_reference(kind):
    port, ref, port_in, ref_in = _block_pair(kind)
    loaded({"b": port}, {"b": ref}, seed=4)
    with torch.no_grad():
        assert rel(port(*port_in), ref(*ref_in)) < FP32_RTOL


def test_blender_is_sigmoid_mix():
    for switch in (False, True):
        blend = M.AlphaBlender(switch)
        blend.mix_factor.data.fill_(0.3)
        s, t = torch.full((3,), 2.0), torch.full((3,), -1.0)
        a = 1 / (1 + math.exp(-0.3))
        a = 1 - a if switch else a
        torch.testing.assert_close(blend(s, t), torch.full((3,), a * 2.0 - (1 - a)))


def _unet_inputs(seed=5, b=2):
    g = torch.Generator().manual_seed(seed)
    u = CFG.unet
    sample = torch.randn(b, FRAMES, 8, 16, u.in_channels, generator=g)
    t = torch.tensor(0.25 * math.log(3.0))
    embeds = torch.randn(b, 1, u.cross_attention_dim, generator=g)
    ids = torch.tensor([[6.0, 127.0, 0.02]]).repeat(b, 1)
    return sample, t, embeds, ids


@pytest.fixture(scope="module")
def unet_pair():
    return loaded({"unet": M.SpatioTemporalUNet(CFG.unet, device="cpu")}, {"unet": R.UNet(CFG_DICT["unet"])}, seed=6)


def test_unet_evaluation_matches_reference(unet_pair):
    port, ref = unet_pair
    args = _unet_inputs()
    with torch.no_grad():
        got, want = port["unet"](*args), ref["unet"](*args)
    assert got.shape == want.shape == args[0].shape[:-1] + (CFG.unet.out_channels,)
    assert rel(got, want) < FP32_RTOL


def test_float8_control_fails_where_bf16_passes(unet_pair):
    """The port in bf16 passes ``BF16_RTOL`` against the fp32 reference;
    the reference with float8 operands (``lower.Lowered``) does not."""
    port, ref = unet_pair
    args = _unet_inputs(seed=7)
    lowered = loaded({"unet": R.UNet(CFG_DICT["unet"])}, {"unet": R.UNet(CFG_DICT["unet"], Lowered())}, seed=6)[1]
    bf16 = M.SpatioTemporalUNet(CFG.unet, device="meta")
    W.load({"unet": bf16}, weights_for({"unet": R.UNet(CFG_DICT["unet"])}, seed=6), dtype=torch.bfloat16)
    with torch.no_grad():
        want = ref["unet"](*args)
        got = bf16(args[0].bfloat16(), args[1], args[2].bfloat16(), args[3]).float()
        control = lowered["unet"](*args)
    assert rel(got, want) < BF16_RTOL < rel(control, want)


@pytest.fixture(scope="module")
def vae_pair():
    return loaded({"vae": M.AutoencoderKLTemporalDecoder(CFG.vae, device="cpu")}, {"vae": R.VAE(CFG_DICT["vae"])},
                  seed=8)


@pytest.mark.parametrize("frames", [4, 1])
def test_temporal_decode_matches_reference(vae_pair, frames):
    """A chunk of ``frames`` frames (one frame: the temporal convs see
    only zero padding), and the encoder's posterior mean."""
    port, ref = vae_pair
    z = torch.randn(2 * frames, 4, 8, 4, generator=torch.Generator().manual_seed(frames))
    with torch.no_grad():
        assert rel(port["vae"].decode(z, frames), ref["vae"].decoder(z, frames)) < FP32_RTOL
        x = torch.rand(1, 16, 32, 3, generator=torch.Generator().manual_seed(9)) * 2 - 1
        assert rel(port["vae"].encode_mean(x), ref["vae"].encode_mean(x)) < FP32_RTOL


def test_euler_sigmas_and_step_are_the_closed_form():
    sched = CFG.scheduler
    n = 25
    sigmas, c_noise = euler_sigmas(sched, n)
    i = np.arange(n, dtype=np.float64) / (n - 1)
    lo, hi = sched.sigma_min ** (1 / 7), sched.sigma_max ** (1 / 7)
    want = (hi + i * (lo - hi)) ** 7
    np.testing.assert_allclose(sigmas.numpy(), np.append(want, 0.0), rtol=1e-6)
    assert sigmas[0] == pytest.approx(700.0) and sigmas[n - 1] == pytest.approx(0.002) and sigmas[n] == 0
    np.testing.assert_allclose(c_noise.numpy(), 0.25 * np.log(want), rtol=1e-6, atol=1e-7)
    assert float(init_noise_sigma(sigmas)) == pytest.approx(math.sqrt(700.0 ** 2 + 1))
    ref_sigmas, ref_c = R.karras(CFG_DICT["scheduler"], n)
    assert torch.equal(ref_sigmas, sigmas) and torch.equal(ref_c, c_noise)
    g = torch.Generator().manual_seed(0)
    v, x = torch.randn(3, generator=g, dtype=torch.float64), torch.randn(3, generator=g, dtype=torch.float64)
    for s, s_next in ((700.0, 500.0), (1.5, 0.0)):
        x0 = -s / math.sqrt(s * s + 1) * v + x / (s * s + 1)
        want_x = x + (x - x0) / s * (s_next - s)
        torch.testing.assert_close(euler_step(v, x, torch.tensor(s, dtype=torch.float64),
                                              torch.tensor(s_next, dtype=torch.float64)), want_x)
    # the last step lands on the denoised sample
    torch.testing.assert_close(euler_step(v, x, torch.tensor(1.5, dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64)),
                               -1.5 / math.sqrt(3.25) * v + x / 3.25)


def _pipeline(dtype="float32", chunk=3, seed=10):
    port = {"unet": M.SpatioTemporalUNet(CFG.unet, device="cpu"), "vae": M.AutoencoderKLTemporalDecoder(CFG.vae, device="cpu"),
            "image_encoder": CLIPVisionEncoder(CFG.image_encoder, device="cpu")}
    ref = R.build(CFG_DICT)
    loaded(port, ref, seed)
    pc = SVDPipelineConfig(num_frames=FRAMES, height=H, width=W_PX, num_inference_steps=3, decode_chunk_size=chunk,
                           dtype=dtype)
    return StableVideoDiffusionPipeline(CFG, port, pc, device="cpu"), ref


def _request(seed=11):
    img = np.random.default_rng(seed).integers(0, 256, (H, W_PX, 3), dtype=np.uint8)
    return {"image": img, "seed": 1234, "frames": FRAMES, "steps": 3, "min_guidance": 1.0, "max_guidance": 3.0,
            "fps": 7, "motion_bucket_id": 127, "noise_aug_strength": 0.02, "decode_chunk": 3}


def test_whole_request_matches_reference():
    """A tiny request (4 frames, 3 Euler steps, decode chunks of 3 + 1)
    end to end: the final latents within ``FP32_RTOL``, the uint8 frames
    within one level (a value on a rounding edge may land either side)."""
    pipe, ref = _pipeline()
    req = _request()
    want_frames, want_latents = R.clip(ref, CFG_DICT, req, "cpu")
    latents = pipe(req["image"], seed=req["seed"], output_type="latent")
    assert rel(torch.as_tensor(latents), want_latents) < FP32_RTOL
    frames = pipe(req["image"], seed=req["seed"])
    assert frames.shape == want_frames.shape == (1, FRAMES, H, W_PX, 3) and frames.dtype == np.uint8
    assert np.abs(frames.astype(int) - want_frames.astype(int)).max() <= 1
    assert pipe.last_dispatch["graph_cache"]["hit"]  # the second call replayed the first's kept loop


def test_request_spans_and_views():
    tracing.clear()
    pipe, _ = _pipeline(chunk=3)
    tracing.enable(True)
    try:
        pipe(_request()["image"], seed=3)
    finally:
        tracing.enable(False)
    root = tracing.roots("request")[-1]
    names = [s.name for s in root.unit if s.parent == root.id]
    assert names == ["inputs", "prep", "denoise", "decode", "finish"]
    assert [s.name for s in root.find("prep")[0].unit] == ["image_encoder", "vae_encode"]
    assert len(root.find("step")) == 3
    chunks = root.find("decode_chunk")
    assert len(chunks) == 2 and all("temporal_conv3" in c.counters for c in chunks)  # the allocator's on a card
    assert "temporal_conv3" in root.counters and "group_norm_fused" in root.counters
    assert set(pipe.last_timings) == {"prep_ms", "step_ms", "decode_ms"} and len(pipe.last_timings["step_ms"]) == 3


def test_cli_serves_svd(tmp_path):
    pipe, _ = _pipeline()
    pipe.save_pretrained(str(tmp_path / "svd"))
    from PIL import Image

    Image.fromarray(_request()["image"]).save(tmp_path / "cond.png")
    (tmp_path / "eval.csv").write_text(f"image_path\n{tmp_path / 'cond.png'}\n")
    argv = ["--model", "svd_xt", "--pretrained_model_path", str(tmp_path / "svd"), "--eval_csv_path",
            str(tmp_path / "eval.csv"), "--output_dir", str(tmp_path / "out"), "--num_frames", str(FRAMES),
            "--height", str(H), "--width", str(W_PX), "--num_inference_steps", "2", "--dtype", "float32",
            "--device", "cpu"]
    written = cli.main(argv)
    assert written == [str(tmp_path / "out" / "svd_xt_0.gif")] and (tmp_path / "out" / "svd_xt_0.gif").exists()
