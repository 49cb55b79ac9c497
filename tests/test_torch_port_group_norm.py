"""The GroupNorm dispatch (``models.layers.group_norm``) off the card.

The hand-written kernel (``ops.norms.group_norm_fused``, ``csrc/group_norm.cu``)
runs only on a CUDA tensor with no gradient recorded; its comparisons with
the composition are the ``gpu`` tests in ``tests/test_torch_port_kernels.py``.
Here: on the CPU and under autograd every call keeps the composition, bit
for bit in its output and its gradients, and the kernel's counter stays 0;
the rule refuses what the kernel cannot read; the grid the wrapper asks for
covers every site's shape and fills the card; the int8 conv's new
``absmax`` argument gives the scale ``aminmax`` gives; and ``chip_smoke``'s
derivations of the kernel's calls equal the calls the card's rule makes
(``group_norm_as_on_card``) in tiny models, and read 82 / 22 / 30 at SD1.5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.models import AutoencoderKL, VideoUNet, layers
from i2v_adapter_tpu_torch.models.simple import SimpleUNet, SimpleUNet3D, SimpleUNetDome
from i2v_adapter_tpu_torch.ops import int8 as I8
from i2v_adapter_tpu_torch.ops import launches, norms
from i2v_adapter_tpu_torch.training import train_latent
from tests.torch_port_common import group_norm_as_on_card, one_torch_thread  # noqa: F401


def _composition(x, groups, eps, weight, bias):
    """The models' GroupNorm as it was written before the kernel."""
    shape = x.shape
    xf = x.reshape(shape[0], -1, groups, shape[-1] // groups).float()
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _operands(dtype=torch.float32, c=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, 3, 5, c, generator=g) * 2 + 0.5).to(dtype)
    weight = (1 + 0.1 * torch.randn(c, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(c, generator=g)).to(dtype)
    return x, weight, bias


@pytest.mark.parametrize("silu", [False, True], ids=["plain", "silu"])
@pytest.mark.parametrize("grad", ["x_and_affine", "affine_only", "none", "no_grad_mode"])
def test_group_norm_keeps_the_composition_off_the_card(grad, silu):
    """Output and gradients equal the composition (then ``F.silu``) bit for
    bit, with and without recorded gradients, and no kernel runs."""
    x, weight, bias = _operands()
    x.requires_grad_(grad == "x_and_affine")
    weight.requires_grad_(grad in ("x_and_affine", "affine_only"))
    bias.requires_grad_(grad in ("x_and_affine", "affine_only"))
    launches.reset()
    with torch.set_grad_enabled(grad != "no_grad_mode"):
        assert not norms.fused_group_norm_applies(x, 8, weight, bias)
        got = layers.group_norm(x, 8, 1e-5, weight, bias, silu=silu)
        want = _composition(x, 8, 1e-5, weight, bias)
        want = F.silu(want) if silu else want
    assert torch.equal(got, want)
    assert launches.snapshot()["group_norm_fused"] == 0
    leaves = [t for t in (x, weight, bias) if t.requires_grad]
    assert got.requires_grad == bool(leaves)
    if leaves:
        cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(1))
        got_grads = torch.autograd.grad(got, leaves, cot)
        want_grads = torch.autograd.grad(want, leaves, cot)
        for a, b in zip(got_grads, want_grads):
            assert torch.equal(a, b)


def test_group_norm_module_absmax_is_none_off_the_card():
    """``GroupNorm(x, silu=True, absmax=True)`` on the CPU: the composition
    and no abs-max, so the int8 conv reads its own."""
    x, weight, bias = _operands()
    norm = layers.GroupNorm(8, 64, 1e-6)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
        y, peak = norm(x, silu=True, absmax=True)
        assert peak is None and torch.equal(y, F.silu(_composition(x, 8, 1e-6, weight, bias)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_group_norm_raises_off_the_card(dtype):
    """The wrapper launches on a CUDA tensor or raises: the CPU's calls take
    ``models.layers.group_norm``'s composition, never the wrapper."""
    x, weight, bias = _operands(dtype)
    launches.reset()
    with pytest.raises(RuntimeError, match="unsupported device"):
        norms.group_norm_fused(x, 8, 1e-5, weight, bias, silu=True, absmax=True)
    assert launches.snapshot()["group_norm_fused"] == 0


# operands the kernel takes (None; a strided or offset x, which the wrapper
# copies) or refuses, device apart: (dtype, channels, groups, what to break)
RULE_CASES = [
    (torch.bfloat16, 320, 32, None), (torch.float32, 320, 32, None), (torch.bfloat16, 2560, 32, None),
    (torch.bfloat16, 128, 32, None), (torch.float32, 2048, 32, None), (torch.bfloat16, 4096, 32, None),
    (torch.float16, 320, 32, "dtype"), (torch.bfloat16, 20, 4, "channels"), (torch.float32, 6, 2, "channels"),
    (torch.float32, 4096, 32, "channels"), (torch.bfloat16, 320, 30, "channels"),
    (torch.bfloat16, 8192, 32, "channels"), (torch.bfloat16, 320, 32, "strided"),
    (torch.bfloat16, 320, 32, "offset"), (torch.bfloat16, 320, 32, "affine_dtype"),
    (torch.bfloat16, 320, 32, "affine_none"),
]


@pytest.mark.parametrize("dtype,c,groups,broken", RULE_CASES,
                         ids=[f"{str(d)[6:]}-{c}-{g}-{b or 'taken'}" for d, c, g, b in RULE_CASES])
def test_fused_group_norm_rule(dtype, c, groups, broken):
    x = torch.zeros(2, 4, 4, c, dtype=dtype)
    if broken == "strided":
        x = torch.zeros(2, 4, 8, c, dtype=dtype)[:, :, ::2]
    if broken == "offset":  # contiguous, one element past an aligned base
        x = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
    weight = torch.ones(c, dtype=torch.float32 if broken == "affine_dtype" else dtype)
    bias = None if broken == "affine_none" else torch.zeros(c, dtype=dtype)
    why = norms._group_norm_refusal(x, groups, weight, bias)
    # a strided or unaligned x is taken: the wrapper copies it first
    assert (why is None) == (broken in (None, "strided", "offset")), why
    # never on the CPU, whatever the operands
    assert not norms.fused_group_norm_applies(x, groups, weight, bias)


# (samples, positions, channels) of the sites at 512 px: spatial resnets /
# transformers at each level, the motion norm over (F, H, W) per clip, the
# decoder's frames, the encoder's one frame; in bf16 and, where the rule
# takes the width, fp32
LAYOUT_SITES = [(32, 4096, 320), (32, 4096, 960), (32, 1024, 1920), (32, 256, 2560), (32, 64, 1280),
                (2, 65536, 320), (2, 16384, 640), (2, 1024, 1280), (16, 262144, 128), (16, 65536, 256),
                (16, 4096, 512), (1, 262144, 128), (32, 16, 2560), (2, 256, 1280)]
LAYOUT_CASES = [(n, rows, c, size) for size in (2, 4) for n, rows, c in LAYOUT_SITES
                if c // (16 // size) <= norms._GN_THREADS]


@pytest.mark.parametrize("n,rows,c,itemsize", LAYOUT_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("per_sm", [2, 3])
def test_group_norm_layout_covers_and_fills(n, rows, c, itemsize, per_sm):
    """The chunks cover each sample's rows exactly once, a CTA stays within
    512 threads and the shared-memory states, and the grid is at most one
    wave of the CTAs an H100 holds at once (132 SMs x ``per_sm``), and a
    whole one less at most n CTAs wherever the rows and the cap on chunks
    allow it."""
    slots = 132 * per_sm
    r, v = norms.group_norm_rows(c, itemsize, rows)
    k, per_chunk = norms.group_norm_layout(n, rows, r, slots)
    assert v == c // (16 // itemsize) and 1 <= r and r * v <= 512 and r * c <= 4096
    assert 1 <= k <= norms._GN_MAX_CHUNKS and (k - 1) * per_chunk < rows <= k * per_chunk
    assert n * k <= max(slots, n)
    if rows >= norms._GN_UNROLL * r * slots:
        assert n * k > min(slots - n, n * norms._GN_MAX_CHUNKS - 1)


def test_int8_conv_takes_a_given_absmax():
    """The scale from a given max |x| is ``activation_scale``'s bit for bit,
    and the conv's output is unchanged by taking it."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 6, 16, generator=g)
    kernel = torch.randn(3, 3, 16, 8, generator=g) / 12
    bias = torch.randn(8, generator=g)
    peak = x.abs().amax()
    assert torch.equal(I8.absmax_scale(peak), I8.activation_scale(x))
    for stride, padding in ((1, 1), (2, 1), (1, 0)):
        assert torch.equal(I8.int8_conv(x, kernel, bias, stride, padding, absmax=peak),
                           I8.int8_conv(x, kernel, bias, stride, padding))


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::group_norm_stats_kernel<__nv_bfloat16>((anonymous namespace)::GnArgs)",
    "void (anonymous namespace)::group_norm_apply_kernel<__nv_bfloat16, true>((anonymous namespace)::GnArgs)",
    "_ZN46_GLOBAL__N__73a4b970_13_group_norm_cu_be668ed023group_norm_apply_kernelIfLb0EEEvNS_6GnArgsE",
], ids=["stats", "apply", "mangled"])
def test_group_norm_kernels_sort_into_norms(name):
    """The kernel's symbols, demangled as the profiler shows them and
    mangled as ptxas prints them, fall into "reduction / norm / softmax" in
    both categorisers, so ``elementwise_ms.*`` keeps counting them."""
    from i2v_adapter_tpu_torch.tools.profile_step import category as tool_category
    from portbench.trace import category

    assert category(name) == tool_category(name) == "reduction / norm / softmax"


@pytest.mark.parametrize("variant", ["auto", "pallas", "int8", "cached"])
def test_unet_group_norm_derivation_matches_the_dispatch(monkeypatch, variant):
    """One tiny VideoUNet evaluation under no grad: the kernel at every
    GroupNorm but the resnets' under ``conv_impl='pallas'`` (folded into
    K4's operands); mid and up only from cached down-path features."""
    calls = group_norm_as_on_card(monkeypatch)
    ucfg = pconfig.tiny_test_config().unet
    ucfg = {"pallas": ucfg.replace(conv_impl="pallas"), "int8": ucfg.replace(int8_conv=True)}.get(variant, ucfg)
    unet = VideoUNet(ucfg, device="cpu")
    args = (torch.zeros(2, 3, 16, 16, 4), 10.0, torch.zeros(2, 5, 16), torch.zeros(2, 8))
    with torch.no_grad():
        _, features = unet(*args, enable_cross_frame_attn=True, return_encoder=True)
        if variant == "cached":
            calls["n"] = 0
            unet(*args, enable_cross_frame_attn=True, cached_encoder=features)
    want = chip_smoke.group_norms_per_unet_eval(ucfg, cached=variant == "cached", dtype=torch.float32)
    assert calls["n"] == want > 0


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_vae_group_norm_derivation_matches_the_dispatch(monkeypatch, part):
    calls = group_norm_as_on_card(monkeypatch)
    vcfg = pconfig.tiny_test_config().vae
    vae = AutoencoderKL(vcfg, device="cpu")
    with torch.no_grad():
        if part == "encoder":
            vae.encode(torch.zeros(2, 16, 16, 3))
        else:
            vae.decode(torch.zeros(2, 8, 8, vcfg.latent_channels))
    assert calls["n"] == chip_smoke.group_norms_per_vae_call(vcfg, part, torch.float32) > 0


@pytest.mark.parametrize("model", ["SimpleUNet", "SimpleUNet3D", "SimpleUNetDome"])
def test_zoo_group_norm_derivation_matches_the_dispatch(monkeypatch, model):
    """The zoo's samplers (two steps, no grad) and the dome's forward run the
    kernel at every GroupNorm module (groups of 8 and 1, fp32); a train
    step, where every weight trains, at none."""
    calls = group_norm_as_on_card(monkeypatch)
    if model == "SimpleUNetDome":
        dome = SimpleUNetDome(device="cpu")
        with torch.no_grad():
            dome(torch.zeros(1, 64, 64, 3), torch.zeros(1, dtype=torch.long))
        assert calls["n"] == chip_smoke.module_group_norms(dome) > 0
        return
    video = model == "SimpleUNet3D"
    unet = (SimpleUNet3D if video else SimpleUNet)(widths=(8, 16), attention_levels=(False, True), heads=2,
                                                   context_dim=16, device="cpu")
    shape = (1, 3, 16, 16, 4) if video else (1, 16, 16, 4)
    train_latent.sample_latents(unet, shape, torch.Generator().manual_seed(0), context=torch.randn(1, 3, 16),
                                schedule_config=train_latent.LATENT_SCHEDULE.replace(num_train_timesteps=2))
    assert calls["n"] == 2 * chip_smoke.module_group_norms(unet) > 0
    calls["n"] = 0
    make = train_latent.make_video_latent_train_step if video else train_latent.make_latent_train_step
    init_fn, step_fn = make(unet)
    step_fn(init_fn(), {"latents": torch.zeros((2,) + shape[1:]), "text_embeds": torch.randn(2, 3, 16)},
            torch.Generator().manual_seed(0))
    assert calls["n"] == 0


@pytest.mark.parametrize("encoder_cache", [1, 2])
def test_request_group_norm_derivation_matches_the_dispatch(monkeypatch, encoder_cache):
    """A tiny request at the serving default (int8 convs, the abs-max handed
    on) through ``__call__``: the evaluations, the condition image's encode
    and the decode, as ``chip_smoke.request_launches`` counts them."""
    from i2v_adapter_tpu_torch.utils.random_init import random_pipeline

    calls = group_norm_as_on_card(monkeypatch)
    mc = pconfig.tiny_test_config()
    pcfg = pconfig.PipelineConfig(num_frames=2, height=32, width=32, num_inference_steps=5, blur_sigma=1.0,
                                  dtype="float32")
    pipe = random_pipeline(mc, pcfg, torch.device("cpu"))
    image = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    pipe("a cat", condition_image=image, seed=0, encoder_cache=encoder_cache)
    steps, latent = len(pipe.last_timings["step_ms"]), 32 // mc.vae.spatial_scale_factor
    want = chip_smoke.request_launches(mc, latent, steps, encoder_cache=encoder_cache)["group_norm_fused"]
    assert calls["n"] == want > 0


def test_group_norm_counts_at_sd15():
    """The derivations at the published widths, as the card run holds them:
    82 an evaluation (52 from cached features, 38 with K4's folded resnet
    norms; 61 on a mesh whose ``seq`` axis takes the motion norms), the VAE
    encoder's 22 and decoder's 30, 1856 a 512 px request, and the train
    step's encode plus the three norms ahead of the first adapter, twice."""
    mc, tc = pconfig.I2VModelConfig(), pconfig.reference_train_config()
    assert chip_smoke.group_norms_per_unet_eval(mc.unet) == 82
    assert chip_smoke.group_norms_per_unet_eval(mc.unet, cached=True) == 52
    assert chip_smoke.group_norms_per_unet_eval(mc.unet.replace(conv_impl="pallas")) == 38
    assert chip_smoke.group_norms_per_unet_eval(mc.unet.replace(conv_impl="pallas", int8_conv=True)) == 82
    assert chip_smoke.group_norms_per_vae_call(mc.vae, "encoder") == 22
    assert chip_smoke.group_norms_per_vae_call(mc.vae, "decoder") == 30
    assert chip_smoke.request_launches(mc, 64, 22)["group_norm_fused"] == 1856
    assert chip_smoke.mesh_launches_per_eval(mc, 64, (1, 1, 2), 16)["group_norm_fused"] == 61
    assert chip_smoke.launches_per_train_step(mc, 32, tc)["group_norm_fused"] == 28
    assert chip_smoke.launches_per_train_step(mc, 32, tc.replace(gradient_checkpointing=False))[
        "group_norm_fused"] == 25
    assert chip_smoke.launches_per_train_step(mc, 32, tc.replace(train_mode="t2i"))["group_norm_fused"] == 22
