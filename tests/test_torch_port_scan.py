"""The scan dispatch, the int8 weight cache, the full_face token check and
the LoRA / textual-inversion loaders of the port, at the tiny config on the
CPU (fp32, exact convs unless a case says int8).

* (a) the port's ``'scan'`` loop (``_denoise_scan``, ``StepGraphs``) against
  the JAX package's ``dispatch='scan'`` sampler (``_sampler``: its own
  ``lax.scan`` over the steps, the encoder-cache pairs and the cfg_cutoff
  split, jitted), both fed the same consts and initial latents and both
  evaluating the port's UNet (the JAX one reached through
  ``jax.pure_callback``, as ``tests/test_torch_port_extras.py`` does, so no
  UNet is compiled): plain CFG, ``encoder_cache=2`` with an odd step,
  ``cfg_cutoff=0.5``; final latents to 1e-4 of max and PSNR > 35 dB;
* (b) ``__call__`` with ``dispatch='scan'`` equal bit for bit to
  ``'stepwise'`` (on the CPU both run eagerly; the scan's steps read their
  timesteps and noise from static buffers), ``eta=0.5`` among the cases;
* (c) ``'auto'``'s choice equal to the JAX ``__call__``'s over a grid of
  frames (temporal windows past the motion cap), sizes, steps and guidance,
  and a callback forcing ``'stepwise'``, with the work threshold set low on
  both sides so both answers occur;
* (d) the int8 sites' cached ``(wq, ws)`` equal to ``quantize_weight_plain``,
  rebuilt for exactly the written site after an in-place change, used by the
  forward without quantising again, dropped when int8 is switched off;
* (e) ``from_pretrained`` refusing a full_face head whose 257 tokens are not
  the image encoder's;
* (f) ``merge_lora`` in the peft and kohya layouts equal to the JAX
  ``merge_lora`` (on the port UNet's own Flax tree, ``to_flax_tree``) to
  1e-6, through ``load_lora_weights`` of files written with the port's
  safetensors writer, and the conv LoRA the JAX package cannot merge;
* (g) ``load_textual_inversion`` in the A1111 and diffusers formats against
  the JAX one: the embedding rows, the token ids and the text encoder's
  output for a prompt using the token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.config import PipelineConfig as JPipelineConfig
from i2v_adapter_tpu.config import tiny_test_config as j_tiny
from i2v_adapter_tpu.models import CLIPTextEncoder as JText
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu.utils.lora import load_textual_inversion as j_load_ti
from i2v_adapter_tpu.utils.lora import merge_lora as j_merge_lora
from i2v_adapter_tpu.utils.tokenizer import make_test_tokenizer as j_make_test_tokenizer
from i2v_adapter_tpu_torch.config import PipelineConfig, tiny_test_config
from i2v_adapter_tpu_torch.models import VideoUNet
from i2v_adapter_tpu_torch.models.layers import (Downsample2D, ResnetBlock2D, Upsample2D, int8_sites,
                                                 prepare_int8, set_int8)
from i2v_adapter_tpu_torch.ops import int8 as I8
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import cfg_steps
from i2v_adapter_tpu_torch.utils import lora as plora
from i2v_adapter_tpu_torch.utils.convert import load_flax_params, to_flax_tree
from i2v_adapter_tpu_torch.utils.random_init import random_pipeline, randomize_
from i2v_adapter_tpu_torch.utils.safetensors_io import save_file
from i2v_adapter_tpu_torch.utils.tokenizer import make_test_tokenizer
from tests import torch_port_synth as psynth
from tests.test_torch_port_extras import PortUNetInJax
from tests.torch_port_common import maxerr, one_torch_thread, psnr  # noqa: F401

T = torch.from_numpy
LAT = 8  # latent side: 16 px frames at the tiny VAE's factor 2
SIZE = 16


def _pcfg():
    cfg = tiny_test_config()
    return cfg.replace(unet=cfg.unet.replace(flash_static_max=0.0, fast_gelu=False))


@pytest.fixture(scope="module")
def pipe():
    pc = PipelineConfig(num_frames=2, height=SIZE, width=SIZE, num_inference_steps=4, blur_sigma=1.0,
                        dtype="float32", int8_conv=False)
    return random_pipeline(_pcfg(), pc, "cpu", seed=3)


# ---------------------------------------------------------------------------
# (a) the scan loop against the JAX package's scan sampler
# ---------------------------------------------------------------------------


SCAN_CASES = {
    "cfg": dict(steps=4),
    "encoder_cache_odd": dict(steps=3, encoder_cache=2),
    "cfg_cutoff_half": dict(steps=5, cfg_cutoff=0.5),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_matches_jax_scan_sampler(pipe, monkeypatch, case):
    kw = SCAN_CASES[case]
    steps, enc, cutoff = kw["steps"], kw.get("encoder_cache", 1), kw.get("cfg_cutoff", 1.0)
    jcfg = j_tiny()
    ucfg = pipe.config.unet
    rng = np.random.default_rng(len(case))
    latents0 = rng.standard_normal((1, 2, LAT, LAT, 4)).astype(np.float32)
    consts = (rng.standard_normal((1, LAT, LAT, 4)).astype(np.float32),
              (rng.standard_normal((2, 16, ucfg.cross_attention_dim)) * 0.5).astype(np.float32),
              rng.standard_normal((2, ucfg.image_embed_dim)).astype(np.float32))

    jpipe = JPipeline.__new__(JPipeline)
    jpipe.config, jpipe.dtype, jpipe.mesh = jcfg, jnp.float32, None
    jpipe.pipe_config = JPipelineConfig(num_frames=2, height=SIZE, width=SIZE, num_inference_steps=steps,
                                        dtype="float32", blur_sigma=1.0, int8_conv=False)
    jpipe.unet = PortUNetInJax(pipe.unet)
    jpipe.schedule = j_make_schedule(jcfg.scheduler)
    real_parts = jpipe._build_parts

    def fed_parts(*a, **k):  # the JAX prep fed the consts, its decode the final clamp
        _, step, _, ts, prev, pair = real_parts(*a, **k)
        prep = lambda *args: ((jnp.asarray(latents0), jax.random.PRNGKey(0)),  # noqa: E731
                              tuple(jnp.asarray(c) for c in consts))
        clamp = lambda params, c, lat: lat.at[:, 0].set(c[0])  # noqa: E731
        return prep, step, clamp, ts, prev, pair

    monkeypatch.setattr(jpipe, "_build_parts", fed_parts)
    sample = jpipe._sampler(1, 2, SIZE, SIZE, steps, 1.0, 7.5, True, True, 0, False, 1, enc, cutoff)
    want = np.asarray(sample({"unet": {}}, None, None, None, jax.random.PRNGKey(0)))

    parts = pipe._build_parts(1, 2, SIZE, SIZE, steps, 1.0, 7.5, True, True)
    pipe.last_timings, pipe.last_dispatch = {}, {}
    with torch.no_grad():
        got = pipe._denoise_scan(parts, tuple(T(c) for c in consts), T(latents0), enc,
                                 cfg_steps(cutoff, len(parts[3])))
        got[:, 0] = T(consts[0])
    assert len(pipe.last_timings["step_ms"]) == len(parts[3]) == steps
    assert got.shape == want.shape
    assert maxerr(got.numpy(), want) < 1e-4 and psnr(got.numpy(), want) > 35.0


# ---------------------------------------------------------------------------
# (b) scan equal to stepwise
# ---------------------------------------------------------------------------


CALL_CASES = {
    "cfg": dict(),
    "encoder_cache_odd": dict(encoder_cache=2, num_inference_steps=4),
    "cfg_cutoff": dict(cfg_cutoff=0.5, num_inference_steps=5),
    "eta": dict(eta=0.5),
    "tiling_encoder_cache": dict(num_frames=12, num_inference_steps=3, encoder_cache=2),
    "unet_chunk": dict(unet_chunk=2, prompt=["a cat", "a dog"]),
    "no_cfg_no_condition": dict(guidance_scale=1.0, image=False),
    "decoded_int8": dict(output_type="np", int8=True),
}


@pytest.mark.parametrize("case", sorted(CALL_CASES))
def test_scan_equals_stepwise(pipe, case):
    kw = dict(CALL_CASES[case])
    eta, int8 = kw.pop("eta", 0.0), kw.pop("int8", False)
    prompt = kw.pop("prompt", "a cat")
    image = None if not kw.pop("image", True) else np.random.default_rng(2).integers(0, 256, (SIZE, SIZE, 3),
                                                                                     dtype=np.uint8)
    p = pipe
    if eta or int8:  # the same modules under another pipeline config
        pc = PipelineConfig(num_frames=2, height=SIZE, width=SIZE, num_inference_steps=4, blur_sigma=1.0,
                            dtype="float32", int8_conv=int8, eta=eta)
        p = I2VAdapterPipeline(_pcfg(), {"unet": pipe.unet, "vae": pipe.vae, "text_encoder": pipe.text_encoder,
                                         "image_encoder": pipe.image_encoder}, pipe.tokenizer, pc, device="cpu")
    call = dict(condition_image=image, seed=7, output_type=kw.pop("output_type", "latent"), **kw)
    try:
        scan = p(prompt, dispatch="scan", **call)
        assert p.last_dispatch["dispatch"] == "scan"
        stepwise = p(prompt, dispatch="stepwise", **call)
        assert p.last_dispatch == {"dispatch": "stepwise"}
    finally:
        if int8:
            p.enable_int8_conv(False)  # the shared modules back to exact convs
    assert np.isfinite(scan).all()
    np.testing.assert_array_equal(scan, stepwise)


# ---------------------------------------------------------------------------
# (c) 'auto' picks as the JAX package picks
# ---------------------------------------------------------------------------


class _Captured(Exception):
    pass


def test_auto_dispatch_matches_jax(pipe, tmp_path, monkeypatch):
    """The JAX ``__call__`` with its two samplers replaced by recorders, the
    port's stopped right after its choice; 48 requests plus callbacks."""
    jpipe = JPipeline.__new__(JPipeline)
    jpipe.config, jpipe.dtype, jpipe.mesh, jpipe.params = j_tiny(), jnp.float32, None, {}
    jpipe.pipe_config = JPipelineConfig(num_frames=2, height=SIZE, width=SIZE, dtype="float32", blur_sigma=1.0)
    jpipe.tokenizer = j_make_test_tokenizer(str(tmp_path))
    seen = []

    def recorder(kind):
        def sampler(*a, **k):
            seen.append(kind)
            return lambda *args, **kw: np.zeros((a[0], a[1], a[2], a[3], 3), np.float32)
        return sampler

    monkeypatch.setattr(jpipe, "_sampler", recorder("scan"))
    monkeypatch.setattr(jpipe, "_stepwise_sampler", recorder("stepwise"))
    # the threshold where these tiny requests fall on both sides of it
    monkeypatch.setattr(JPipeline, "SCAN_DISPATCH_MAX_WORK", 3000)
    monkeypatch.setattr(I2VAdapterPipeline, "SCAN_DISPATCH_MAX_WORK", 3000)
    real = pipe._resolve_dispatch
    chosen = []
    monkeypatch.setattr(pipe, "_resolve_dispatch", lambda *a: chosen.append(real(*a)) or chosen[-1])

    def stop(*a, **k):
        raise _Captured

    monkeypatch.setattr(pipe, "_build_parts", stop)
    image = np.zeros((SIZE, SIZE, 3), np.uint8)
    cases = [dict(num_frames=f, height=s, width=s, num_inference_steps=n, guidance_scale=g, prompt=p)
             for f in (2, 12) for s in (16, 32) for n in (2, 5) for g in (7.5, 1.0) for p in (["a"], ["a", "b"])]
    cases += [dict(num_frames=2, height=16, width=16, num_inference_steps=2, guidance_scale=7.5, prompt=["a"],
                   callback=lambda *a: None), dict(num_frames=12, height=16, width=16, num_inference_steps=2,
                                                   guidance_scale=7.5, prompt=["a"], dispatch="scan")]
    for c in cases:
        c = dict(c)
        prompt = c.pop("prompt")
        args = dict(condition_image=image, seed=0, memory_unsafe=True, output_type="np", **c)
        jpipe(prompt, **args)
        with pytest.raises(_Captured):
            pipe(prompt, **args)
    assert chosen == seen and len(seen) == len(cases)
    assert {"scan", "stepwise"} <= set(seen) and seen[-2:] == ["stepwise", "scan"]


# ---------------------------------------------------------------------------
# (d) the int8 weights, quantised once per weights version
# ---------------------------------------------------------------------------


def test_int8_weight_cache(monkeypatch):
    ucfg = _pcfg().unet.replace(int8_conv=True)
    unet = randomize_(VideoUNet(ucfg, device="cpu"), seed=5)
    sites = int8_sites(unet)
    kinds = [type(m) for m in unet.modules()]
    assert len({id(s) for s in sites}) == len(sites) == 2 * kinds.count(ResnetBlock2D) + kinds.count(
        Downsample2D) + kinds.count(Upsample2D)
    assert prepare_int8(unet) == len(sites) and prepare_int8(unet) == 0
    for conv in sites:
        wq, ws = I8.quantize_weight_plain(conv.weight.permute(2, 3, 1, 0))
        got = I8.cached_weights(conv.weight.permute(2, 3, 1, 0))
        assert torch.equal(got[0], wq) and torch.equal(got[1], ws)
    # an in-place write rebuilds that site only
    kept = {id(c): c.weight._int8_weights for c in sites}
    with torch.no_grad():
        sites[3].weight.mul_(2.0)
    assert prepare_int8(unet) == 1
    wq, ws = I8.quantize_weight_plain(sites[3].weight.permute(2, 3, 1, 0))
    assert torch.equal(sites[3].weight._int8_weights[1], wq) and torch.equal(sites[3].weight._int8_weights[2], ws)
    assert all(c.weight._int8_weights is kept[id(c)] for i, c in enumerate(sites) if i != 3)
    # any other kernel (not a parameter's HWIO view) has no cached pair
    assert I8.cached_weights(sites[0].weight.detach().permute(2, 3, 1, 0)) is None
    # the forward reads the cache: no quantiser runs
    calls = []
    monkeypatch.setattr(I8, "quantize_weight_plain", lambda k: calls.append(1))
    x = torch.randn(2, 2, 16, 16, 4)
    with torch.no_grad():
        out = unet(x, 10.0, torch.randn(2, 5, ucfg.cross_attention_dim), torch.randn(2, ucfg.image_embed_dim),
                   enable_cross_frame_attn=True)
    assert not calls and torch.isfinite(out).all()
    set_int8(unet, False)
    assert not any("_int8_weights" in c.weight.__dict__ for c in sites)


# ---------------------------------------------------------------------------
# (e) the full_face head's token count
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan_ckpt")
    cfg = tiny_test_config()
    ff = cfg.replace(image_encoder=cfg.image_encoder.replace(image_size=32, patch_size=2))
    psynth.write_pretrained_dir(str(root / "sd"), cfg, seed=1)
    psynth.write_pretrained_dir(str(root / "ff"), ff, seed=2)
    psynth.save_ip_adapter(psynth.make_ip_adapter_sd(psynth.Draw(3), cfg, "full_face"), str(root / "ff.bin"))
    return {"sd": str(root / "sd"), "ff": str(root / "ff"), "ip": str(root / "ff.bin"), "cfg": cfg, "ff_cfg": ff}


def test_full_face_token_count_refused(ckpt):
    """257 tokens (the layout's count) against the tiny encoder's 5: refused
    before the UNet is read; an encoder of 16 x 16 patches + 1 loads."""
    with pytest.raises(ValueError, match="full_face head carries 257 image tokens, the image encoder gives 5"):
        I2VAdapterPipeline.from_pretrained(ckpt["sd"], model_config=ckpt["cfg"], ip_adapter_path=ckpt["ip"],
                                           pipeline_config=PipelineConfig(dtype="float32"), device="cpu")
    pipe = I2VAdapterPipeline.from_pretrained(ckpt["ff"], model_config=ckpt["ff_cfg"], ip_adapter_path=ckpt["ip"],
                                              pipeline_config=PipelineConfig(dtype="float32"), device="cpu")
    assert pipe.config.unet.ip_variant == "full_face" and pipe.config.unet.ip_num_tokens == 257


# ---------------------------------------------------------------------------
# (f) LoRA
# ---------------------------------------------------------------------------


def _lora_sd(unet, layout, rng, alpha=None):
    """A rank-2 LoRA on five kinds of Linear (attn1 q, attn2 k, to_out.0,
    the feed-forward's two) of two transformer blocks, diffusers paths."""
    linears = ["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q",
               "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k",
               "mid_block.attentions.0.transformer_blocks.0.attn1.to_out.0",
               "mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj",
               "up_blocks.1.attentions.1.transformer_blocks.0.ff.net.2"]
    weights = dict(unet.named_parameters())
    sd = {}
    for path in linears:
        cout, cin = weights[plora._torch_path_to_port(path) + ".weight"].shape
        down = rng.standard_normal((2, cin)).astype(np.float32)
        up = (rng.standard_normal((cout, 2)) * 0.1).astype(np.float32)
        if layout == "peft":
            sd[f"unet.{path}.lora_A.weight"], sd[f"unet.{path}.lora_B.weight"] = down, up
        else:
            key = "lora_unet_" + path.replace(".", "_")
            sd[f"{key}.lora_down.weight"], sd[f"{key}.lora_up.weight"] = down, up
            sd[f"{key}.alpha"] = np.array(alpha, np.float32)
    sd["lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight"] = np.ones((2, 4), np.float32)
    return sd


@pytest.mark.parametrize("layout", ["peft", "kohya"])
def test_merge_lora_matches_jax(pipe, tmp_path, layout):
    rng = np.random.default_rng(len(layout))
    base = {n: p.detach().clone() for n, p in pipe.unet.named_parameters()}
    tree = to_flax_tree(pipe.unet)
    sd = _lora_sd(pipe.unet, layout, rng, alpha=1.0)
    path = str(tmp_path / f"{layout}.safetensors")
    save_file(sd, path)
    want_tree, want_n = j_merge_lora(tree, sd, 0.7)
    try:
        assert pipe.load_lora_weights(path, scale=0.7) == want_n == 5
        want = load_flax_params(VideoUNet(pipe.config.unet, device="cpu"), want_tree)
        got = dict(pipe.unet.named_parameters())
        for name, w in want.named_parameters():
            assert maxerr(got[name].detach().numpy(), w.detach().numpy()) <= 1e-6, name
        changed = [n for n in base if not torch.equal(base[n], got[n])]
        assert len(changed) == 5
    finally:
        with torch.no_grad():
            for n, p in pipe.unet.named_parameters():
                p.copy_(base[n])


def test_merge_lora_conv_and_refusal():
    """kohya's conv LoRA (3x3 down, 1x1 up) into a resnet conv, which the
    JAX package cannot merge: W += alpha / rank * scale * up . down; a file
    that matches nothing raises the JAX ValueError."""
    unet = randomize_(VideoUNet(_pcfg().unet, device="cpu"), seed=6)
    conv = dict(unet.named_parameters())["down_blocks_0.resnets_0.conv1.weight"]
    before = conv.detach().clone()
    rng = np.random.default_rng(0)
    down = rng.standard_normal((4, conv.shape[1], 3, 3)).astype(np.float32)
    up = rng.standard_normal((conv.shape[0], 4, 1, 1)).astype(np.float32)
    key = "lora_unet_down_blocks_0_resnets_0_conv1"
    sd = {f"{key}.lora_down.weight": down, f"{key}.lora_up.weight": up, f"{key}.alpha": np.array(2.0, np.float32)}
    assert plora.merge_lora(unet, sd, scale=0.5) == 1
    delta = torch.einsum("or,rikl->oikl", T(up[:, :, 0, 0]), T(down)) * (2.0 / 4 * 0.5)
    assert maxerr((conv.detach() - before).numpy(), delta.numpy()) <= 1e-6
    with pytest.raises(ValueError, match="no LoRA layers matched"):
        plora.merge_lora(unet, {"unet.bogus.lora_A.weight": down[:, :, 0, 0],
                                "unet.bogus.lora_B.weight": up[..., 0, 0]})


# ---------------------------------------------------------------------------
# (g) textual inversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["a1111", "diffusers"])
def test_textual_inversion_matches_jax(tmp_path, fmt):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    tok, jtok = make_test_tokenizer(str(tmp_path / "p")), j_make_test_tokenizer(str(tmp_path / "j"))
    cfg = _pcfg()
    cfg = cfg.replace(text_encoder=cfg.text_encoder.replace(vocab_size=len(tok.encoder)))
    pc = PipelineConfig(num_frames=2, height=SIZE, width=SIZE, dtype="float32", int8_conv=False)
    p = random_pipeline(cfg, pc, "cpu", seed=4)
    p.tokenizer = tok
    tree = to_flax_tree(p.text_encoder)
    emb = np.random.default_rng(9).standard_normal((2, cfg.text_encoder.hidden_size)).astype(np.float32)
    if fmt == "a1111":
        path = str(tmp_path / "emb.pt")
        torch.save({"string_to_param": {"*": T(emb)}, "name": "sks"}, path)
    else:
        path = str(tmp_path / "emb.safetensors")
        save_file({"<sks>": emb}, path)
    p.load_textual_inversion(path, "<sks>")
    want_tree = j_load_ti(tree, jtok, emb, "<sks>")
    table = p.text_encoder.token_embedding.weight.detach()
    np.testing.assert_array_equal(table.numpy(), want_tree["token_embedding"]["embedding"])
    assert p.config.text_encoder.vocab_size == table.shape[0] == len(tok.encoder) == len(jtok.encoder)
    assert tok.encoder["<sks>"] == jtok.encoder["<sks>"] and tok.encoder["<sks>_1"] == jtok.encoder["<sks>_1"]
    ids = np.asarray(tok(["a <sks> cat"]))
    np.testing.assert_array_equal(ids, np.asarray(jtok(["a <sks> cat"])))
    assert tok.encoder["<sks>"] in ids
    jcfg = j_tiny().text_encoder.replace(vocab_size=table.shape[0])
    want = jax.jit(JText(jcfg).apply)({"params": want_tree}, jnp.asarray(ids))
    with torch.no_grad():
        got = p.text_encoder(T(ids))
    assert maxerr(got.numpy(), want) < 1e-4
    with pytest.raises(ValueError, match="unrecognized textual-inversion format"):
        bad = str(tmp_path / "bad.safetensors")
        save_file({"a": emb, "b": emb}, bad)
        p.load_textual_inversion(bad, "<x>")
