"""PyTorch port vs the JAX package: the fused-conv configuration
(``conv_impl='pallas'``) on the CPU, fp32, tiny sizes.

The JAX side runs its Pallas conv in interpret mode, as
``tests/test_ops_conv3x3.py`` does; the port's wrappers take their plain
versions because the tensors lie on the CPU.  Inputs come from numpy seeds.

* plain ``conv3x3`` / ``gn_silu_conv3x3`` vs ``conv3x3_pallas(interpret=True)``
  (multi-row-block and ragged shapes): rtol 1e-5 / atol 1e-4;
* ``fold_gn_affine`` and the statistics vs the JAX ones: 1e-5;
* ``ResnetBlock2D(conv_impl='pallas')`` vs the Flax one through
  ``load_flax_params`` (1e-4 of max), same state-dict keys under both impls;
* gradients of the two autograd Functions vs ``jax.grad`` of the custom-VJP
  entries, all inputs: rtol 1e-4 / atol 1e-3;
* one tiny UNet evaluation and one tiny train step (loss, grad norm) with
  ``conv_impl='pallas'`` on both sides: 1e-4;
* the K4 launch-count derivation vs a counted run at the tiny config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from i2v_adapter_tpu import config as jconfig
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.models.layers import ResnetBlock2D as JResnet
from i2v_adapter_tpu.models.layers import _fold_gn_affine as j_fold
from i2v_adapter_tpu.ops import conv3x3 as jconv
from i2v_adapter_tpu.ops.norms import group_norm_apply as j_gn_apply
from i2v_adapter_tpu.ops.norms import group_norm_stats_matmul as j_stats
from i2v_adapter_tpu.training import state as jstate
from i2v_adapter_tpu.training.train_i2v import make_train_step as j_make_train_step
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.models import VideoUNet
from i2v_adapter_tpu_torch.models import layers as player
from i2v_adapter_tpu_torch.models.layers import ResnetBlock2D
from i2v_adapter_tpu_torch.ops import conv3x3 as pconv
from i2v_adapter_tpu_torch.ops.norms import fold_gn_affine, group_norm_apply, group_norm_stats_matmul
from i2v_adapter_tpu_torch.training import create_train_state, make_train_step
from i2v_adapter_tpu_torch.utils.convert import load_flax_params, load_train_state
from tests.test_torch_port_training import _draws, _jax_params, _port_models
from tests.torch_port_common import maxerr, one_torch_thread, random_params  # noqa: F401

T = torch.from_numpy


def _conv_inputs(seed, b, h, w, c, co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) / (3 * c) ** 0.5).astype(np.float32)
    bias = rng.standard_normal((co,)).astype(np.float32)
    a = (rng.random((b, c)) + 0.5).astype(np.float32)
    s = rng.standard_normal((b, c)).astype(np.float32)
    return x, k, bias, a, s


@pytest.mark.parametrize("shape,rows", [
    ((2, 8, 8, 16, 24), 0),
    ((1, 16, 8, 16, 16), 4),   # 4 row blocks on the JAX side: halos and edge masks
    ((2, 12, 8, 136, 264), 4),  # the reference's ragged shape
])
@pytest.mark.parametrize("fused", [False, True], ids=["conv", "gn_silu_conv"])
def test_plain_conv_matches_pallas_interpret(shape, rows, fused):
    x, k, bias, a, s = _conv_inputs(sum(shape), *shape)
    pre = (jnp.asarray(a), jnp.asarray(s)) if fused else ()
    want = jconv.conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), *pre,
                                interpret=True, rows=rows)
    pconv.reset_launch_counts()
    if fused:
        got = pconv.gn_silu_conv3x3(T(x), T(a), T(s), T(k), T(bias))
    else:
        got = pconv.conv3x3(T(x), T(k), T(bias))
    assert pconv.launch_counts() == {"conv3x3_kernel": 0}  # a CPU tensor launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_padding_is_zero_after_the_activation():
    """A border tap contributes 0, not silu(shift): with x = 0 and a
    constant kernel the corner output sums 4 taps, an edge 6, the centre 9."""
    c = 8
    x = torch.zeros(1, 4, 4, c)
    a, s = torch.ones(1, c), torch.full((1, c), 2.0)
    out = pconv.gn_silu_conv3x3(x, a, s, torch.ones(3, 3, c, 1), torch.zeros(1))[0, :, :, 0]
    unit = float(torch.nn.functional.silu(torch.tensor(2.0))) * c
    np.testing.assert_allclose(out[0, 0], 4 * unit, rtol=1e-6)
    np.testing.assert_allclose(out[0, 1], 6 * unit, rtol=1e-6)
    np.testing.assert_allclose(out[1, 1], 9 * unit, rtol=1e-6)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8), ((3, 2, 6, 5, 24), 4)])
def test_group_norm_stats_and_fold_match_jax(shape, groups):
    rng = np.random.default_rng(len(shape) + groups)
    h = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    beta = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jm, jv = j_stats(jnp.asarray(h), groups)
    pm, pv = group_norm_stats_matmul(T(h), groups)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    want = j_gn_apply(jnp.asarray(h), jm, jv, jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-5)
    got = group_norm_apply(T(h), pm, pv, T(gamma), T(beta), groups, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    ja, js = j_fold(jnp.asarray(h), groups, 1e-5, jnp.asarray(gamma), jnp.asarray(beta))
    pa, ps = fold_gn_affine(T(h), groups, 1e-5, T(gamma), T(beta))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    # the fold is GroupNorm: h*a + s equals the port's two-pass group_norm
    folded = T(h) * pa.reshape((shape[0],) + (1,) * (len(shape) - 2) + (-1,)) + ps.reshape(
        (shape[0],) + (1,) * (len(shape) - 2) + (-1,))
    two_pass = player.group_norm(T(h), groups, 1e-5, T(gamma), T(beta))
    assert maxerr(folded.numpy(), two_pass.numpy()) < 1e-5


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
def test_resnet_block_pallas_matches_flax(cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = (rng.standard_normal((2, 8, 8, cin)) * 2 + 0.5).astype(np.float32)
    temb = rng.standard_normal((2, 64)).astype(np.float32)
    jm = JResnet(out_channels=cout, groups=8, conv_impl="pallas")
    params = random_params(jm, jnp.asarray(x), jnp.asarray(temb), seed=1)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(temb))
    fused = load_flax_params(ResnetBlock2D(cin, cout, 64, groups=8, conv_impl="pallas"), params)
    library = load_flax_params(ResnetBlock2D(cin, cout, 64, groups=8), params)
    assert list(fused.state_dict()) == list(library.state_dict())
    with torch.no_grad():
        got = fused(T(x), T(temb)).numpy()
        ref = library(T(x), T(temb)).numpy()
    assert maxerr(got, want) < 1e-4
    assert maxerr(got, ref) < 1e-4


def test_resnet_block_refuses_unknown_conv_impl():
    with pytest.raises(ValueError, match="conv_impl"):
        ResnetBlock2D(8, 8, conv_impl="bogus")


@pytest.mark.parametrize("fused", [False, True], ids=["Conv3x3Fn", "GnSiluConv3x3Fn"])
def test_function_gradients_match_jax_custom_vjp(fused):
    """Gradients w.r.t. every input (x, [a, s,] kernel, bias) of
    sum(out^2), through the autograd Function vs jax.grad of the entry."""
    x, k, bias, a, s = _conv_inputs(3, 2, 8, 8, 16, 24)
    if fused:
        arrays = (x, a, s, k, bias)
        jfn = lambda *t: jnp.sum(jconv.gn_silu_conv3x3(*t, True) ** 2)
        entry = pconv.gn_silu_conv3x3
    else:
        arrays = (x, k, bias)
        jfn = lambda *t: jnp.sum(jconv.conv3x3(*t, True) ** 2)
        entry = pconv.conv3x3
    want = jax.grad(jfn, argnums=tuple(range(len(arrays))))(*(jnp.asarray(t) for t in arrays))
    inputs = [T(t.copy()).requires_grad_() for t in arrays]
    out = entry(*inputs)
    assert type(out.grad_fn).__name__.startswith("GnSiluConv3x3Fn" if fused else "Conv3x3Fn")
    got = torch.autograd.grad((out ** 2).sum(), inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)


def test_function_gradient_only_for_inputs_that_need_it():
    x, k, bias, a, s = (T(t) for t in _conv_inputs(4, 1, 4, 4, 8, 8))
    k.requires_grad_()
    out = pconv.gn_silu_conv3x3(x, a, s, k, bias)
    (gk,) = torch.autograd.grad(out.sum(), [k])
    ref = pconv.gn_silu_conv3x3_plain(x, a, s, k, bias)
    (want,) = torch.autograd.grad(ref.sum(), [k])
    torch.testing.assert_close(gk, want)


def test_conv3x3_supported_gate_matches_jax():
    cases = [((2, 8, 8, 320), (3, 3, 320, 320)), ((2, 8, 8, 4), (3, 3, 4, 320)),
             ((2, 8, 8, 320), (1, 1, 320, 320)), ((1, 6, 3, 136), (3, 3, 136, 264)),
             ((2, 8, 8, 2560), (3, 3, 2560, 1280)), ((1, 8, 8, 132), (3, 3, 132, 128))]
    for xs, ks in cases:
        assert pconv.conv3x3_supported(torch.zeros(xs), torch.zeros(ks)) == \
            jconv.conv3x3_supported(jnp.zeros(xs), jnp.zeros(ks)), (xs, ks)


def test_wrapper_checks_shapes():
    x, k, bias, a, s = (T(t) for t in _conv_inputs(5, 1, 4, 4, 8, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        pconv.conv3x3_kernel(x, k[:, :, :4], bias)
    with pytest.raises(ValueError, match="come together"):
        pconv.conv3x3_kernel(x, k, bias, a, None)
    with pytest.raises(ValueError, match="pre_scale"):
        pconv.conv3x3_kernel(x, k, bias, a[:, :4], s[:, :4])


# ---------------------------------------------------------------------------
# the slice as a whole: UNet evaluation and train step with conv_impl='pallas'
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


def test_video_unet_pallas_matches_jax(jax_params):
    """One evaluation at the tiny config, both sides with conv_impl='pallas'
    (the JAX side jitted, its conv in interpret mode), from the same Flax
    tree that the 'auto' model loads."""
    mc, unet_params = jax_params[:2]
    ucfg = mc.unet.replace(conv_impl="pallas", flash_attention=False)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 2, 16, 16, 4)).astype(np.float32)
    txt = (rng.standard_normal((2, 7, ucfg.cross_attention_dim)) * 0.5).astype(np.float32)
    img = rng.standard_normal((2, ucfg.image_embed_dim)).astype(np.float32)
    t = np.array([421.0, 421.0], np.float32)
    apply = jax.jit(lambda p, *a: JUNet(ucfg).apply(p, *a, enable_cross_frame_attn=True))
    want = apply(unet_params, *(jnp.asarray(v) for v in (x, t, txt, img)))
    pcfg = pconfig.VideoUNetConfig.from_dict(ucfg.to_dict())
    pm = load_flax_params(VideoUNet(pcfg, device="cpu"), unet_params)
    auto = load_flax_params(VideoUNet(pcfg.replace(conv_impl="auto"), device="cpu"), unet_params)
    assert list(pm.state_dict()) == list(auto.state_dict())
    with torch.no_grad():
        got = pm(T(x), T(t), T(txt), T(img), enable_cross_frame_attn=True).numpy()
        ref = auto(T(x), T(t), T(txt), T(img), enable_cross_frame_attn=True).numpy()
    assert got.shape == (2, 2, 16, 16, 4)
    assert maxerr(got, want) < 1e-4
    assert maxerr(got, ref) < 1e-4


def test_train_step_pallas_matches_jax(jax_params):
    """One train step at the tiny config with conv_impl='pallas' and
    activation checkpointing on both sides, fed the JAX draws: loss and
    grad norm to 1e-4."""
    B, F, RES, L = 2, 3, 32, 16
    mc, unet_params, vae_params, text_params, image_params = jax_params
    mc = mc.replace(unet=mc.unet.replace(conv_impl="pallas", remat=True))
    jtc = jconfig.TrainConfig(
        train_batch_size=B, num_frames=F, resolution=RES, gradient_accumulation_steps=1,
        mixed_precision="none", gradient_checkpointing=True,
        optimizer=jconfig.OptimizerConfig(learning_rate=1.0, adam_epsilon=1.0,
                                          adam_weight_decay=0.0))
    lat = RES // mc.vae.spatial_scale_factor
    draws = _draws(jax.random.PRNGKey(0), B, F, lat, jtc)
    rng = np.random.default_rng(5)
    batch = {
        "pixel_values": rng.uniform(-1, 1, (B, F, RES, RES, 3)).astype(np.float32),
        "text_ids": rng.integers(0, 1000, (B, L)).astype(np.int32),
        "uncond_ids": np.zeros((B, L), np.int32),
        "clip_image": rng.standard_normal((B, 28, 28, 3)).astype(np.float32),
    }
    jst, tx = jstate.create_train_state(unet_params, jtc, 10, vae_params, text_params, image_params)
    _, jm = j_make_train_step(mc, jtc, tx, donate=False)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    pc, (unet, vae, text, image) = _port_models(mc)
    assert pc.unet.conv_impl == "pallas" and pc.unet.remat
    ptc = pconfig.TrainConfig.from_dict(jtc.to_dict())
    pst = load_train_state(create_train_state(unet, ptc, 10, vae, text, image), jst)
    _, pm = make_train_step(pc, ptc, device="cpu")(
        pst, batch, draws={k: np.asarray(v) for k, v in draws.items()})
    assert float(pm["skipped_nonfinite"]) == float(jm["skipped_nonfinite"]) == 0.0
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=1e-4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_step_remat"])
def test_conv_launch_derivation_matches_the_model(monkeypatch, train):
    """chip_smoke's K4 launch count per UNet evaluation (and per train step
    under activation checkpointing) equals the wrapper calls of a real tiny
    run; at the SD1.5 config it is 44 and 88."""
    calls = {"n": 0}
    real = pconv.conv3x3_kernel

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(pconv, "conv3x3_kernel", counting)
    mc = pconfig.tiny_test_config()
    mc = mc.replace(unet=mc.unet.replace(conv_impl="pallas"))
    if train:
        from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state

        tc = pconfig.TrainConfig(train_batch_size=2, num_frames=2, resolution=32,
                                 gradient_accumulation_steps=1, gradient_checkpointing=True,
                                 mixed_precision="none")
        mc = mc.replace(unet=mc.unet.replace(remat=True))
        state = random_train_state(mc, tc, "cpu")
        make_train_step(mc, tc, device="cpu")(state, random_train_batch(mc, tc, "cpu"))
        assert calls["n"] == 2 * chip_smoke.conv_launches_per_unet_eval(mc.unet)
    else:
        unet = VideoUNet(mc.unet, device="cpu")
        with torch.no_grad():
            unet(torch.zeros(2, 3, 16, 16, 4), 10.0, torch.zeros(2, 5, 16), torch.zeros(2, 8),
                 enable_cross_frame_attn=True)
        assert calls["n"] == chip_smoke.conv_launches_per_unet_eval(mc.unet)
    full = pconfig.VideoUNetConfig(conv_impl="pallas")
    assert chip_smoke.conv_launches_per_unet_eval(full) == 44
    assert chip_smoke.conv_launches_per_unet_eval(pconfig.VideoUNetConfig()) == 0
    sites = chip_smoke.conv_sites(full, 64)
    assert sum(n for *_, n in sites) == 44
    assert {(h, sum(n for hh, _, _, n in sites if hh == h)) for h, *_ in sites} == {
        (64, 10), (32, 10), (16, 10), (8, 14)}
