"""The checkpoint slice: the port's key maps, safetensors I/O and
``I2VAdapterPipeline.from_pretrained`` against the JAX package's, at the
tiny config on the CPU.  Nothing here is jitted: the JAX side only
converts numpy state dicts and constructs its pipeline.

* every converter (UNet with motion modules and the zero-init adapter, with
  a given adapter, without IP / motion; VAE with new and legacy attention
  keys; CLIP text and vision) equal to its JAX counterpart leaf for leaf
  (keys, shapes, dtypes, values), on ``tests/synth.py``'s state dicts;
* IP-Adapter variant detection, config updates and head conversion for
  the standard, plus and full_face layouts;
* ``extract_*`` / ``merge_*`` against JAX, and their round trips;
* the port's safetensors reader and writer against ``safetensors.numpy``,
  both ways, bit for bit (F32, F16, BF16, I64, I32);
* ``tests/torch_port_synth.py`` writes the names, shapes and dtypes of
  ``tests/synth.py::write_pretrained_dir``;
* ``from_pretrained``: every module's state dict equal, bit for bit, to
  ``load_flax_params`` of the JAX ``from_pretrained`` tree (fp32 and bf16
  pipelines, with and without an adapter checkpoint; an fp16 directory
  stored in the compute dtype; plus and full_face IP checkpoints), the same
  tokenizer ids and IP config; one ``output_type='latent'`` call equal to the
  same call on a pipeline built from the JAX tree; a plus head wider than
  the image encoder and missing weights refused.
"""

import json
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

from i2v_adapter_tpu.config import PipelineConfig as JPipelineConfig
from i2v_adapter_tpu.config import tiny_test_config as j_tiny
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.utils import convert as jconv
from i2v_adapter_tpu_torch.config import PipelineConfig, tiny_test_config
from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.utils import convert as pconv
from i2v_adapter_tpu_torch.utils import safetensors_io
from tests import synth
from tests import torch_port_synth as psynth
from tests.torch_port_common import one_torch_thread  # noqa: F401

JCFG, PCFG = j_tiny(), tiny_test_config()
# tests/synth.py's weights are unscaled N(0, 1): the flash sites' logits
# leave the static softmax offset's range, so runs use the exact softmax
EXACT_PCFG = PCFG.replace(unet=PCFG.unet.replace(flash_static_max=0.0))
# a full_face head carries 257 image tokens (its layout's count): the tiny
# image encoder at 32 px in 2 px patches gives 16 x 16 + 1 of them
FF_JCFG = JCFG.replace(image_encoder=JCFG.image_encoder.replace(image_size=32, patch_size=2))
FF_PCFG = PCFG.replace(image_encoder=PCFG.image_encoder.replace(image_size=32, patch_size=2))
MODULES = {"unet": VideoUNet, "vae": AutoencoderKL, "text_encoder": CLIPTextEncoder,
           "image_encoder": CLIPVisionEncoder}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    """Same keys, shapes, dtypes and values (bit patterns)."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == np.ascontiguousarray(want[k]).tobytes(), k


@pytest.fixture(scope="module")
def sds():
    rng = np.random.default_rng(0)
    unet, motion, ip = synth.make_unet_sd(rng, JCFG.unet)
    adapter = psynth.make_adapter_sd(psynth.Draw(5), PCFG.unet)
    vae = synth.make_vae_sd(rng, JCFG.vae)
    legacy = {}
    for k, v in vae.items():  # the legacy attention keys: 1x1 convs named query/key/value/proj_attn
        for new, old in (("to_q", "query"), ("to_k", "key"), ("to_v", "value"), ("to_out.0", "proj_attn")):
            if f"attentions.0.{new}." in k:
                k, v = k.replace(f".{new}.", f".{old}."), (v[:, :, None, None] if v.ndim == 2 else v)
        legacy[k] = v
    return {"unet": unet, "motion": motion, "ip": ip, "adapter": adapter, "vae": vae, "vae_legacy": legacy,
            "text": synth.make_clip_text_sd(rng, JCFG.text_encoder),
            "vision": synth.make_clip_vision_sd(rng, JCFG.image_encoder)}


CONVERTERS = {
    "unet_motion_zero_init_adapter_ip": lambda m, s, c: m.convert_unet(s["unet"], c.unet, s["motion"], None, s["ip"]),
    "unet_given_adapter": lambda m, s, c: m.convert_unet(s["unet"], c.unet, s["motion"], s["adapter"], s["ip"]),
    "unet_no_motion_no_ip": lambda m, s, c: m.convert_unet(
        s["unet"], c.unet.replace(use_motion_modules=False, use_ip_adapter=False), s["motion"]),
    "vae": lambda m, s, c: m.convert_vae(s["vae"], c.vae),
    "vae_legacy_attention": lambda m, s, c: m.convert_vae(s["vae_legacy"], c.vae),
    "clip_text": lambda m, s, c: m.convert_clip_text(s["text"], c.text_encoder),
    "clip_vision": lambda m, s, c: m.convert_clip_vision(s["vision"], c.image_encoder),
}


@pytest.mark.parametrize("case", sorted(CONVERTERS))
def test_converter_matches_jax(sds, case):
    assert_trees_equal(CONVERTERS[case](pconv, sds, PCFG), CONVERTERS[case](jconv, sds, JCFG))


def ip_state_dict(variant, rng):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    ip = synth.make_unet_sd(np.random.default_rng(1), JCFG.unet)[2]
    if variant == "standard":
        return ip
    if variant == "full_face":
        proj = {"proj.0.weight": r(32, 24), "proj.0.bias": r(32), "proj.2.weight": r(16, 32),
                "proj.2.bias": r(16), "proj.3.weight": r(16), "proj.3.bias": r(16)}
    else:
        proj = {"latents": r(1, 6, 12), "proj_in.weight": r(12, 24), "proj_in.bias": r(12),
                "proj_out.weight": r(16, 12), "proj_out.bias": r(16), "norm_out.weight": r(16),
                "norm_out.bias": r(16)}
        for i in range(2):
            for n in ("norm1", "norm2"):
                proj[f"layers.{i}.0.{n}.weight"], proj[f"layers.{i}.0.{n}.bias"] = r(12), r(12)
            proj[f"layers.{i}.0.to_q.weight"], proj[f"layers.{i}.0.to_kv.weight"] = r(12, 12), r(24, 12)
            proj[f"layers.{i}.0.to_out.weight"] = r(12, 12)
            proj[f"layers.{i}.1.0.weight"], proj[f"layers.{i}.1.0.bias"] = r(12), r(12)
            proj[f"layers.{i}.1.1.weight"], proj[f"layers.{i}.1.3.weight"] = r(48, 12), r(12, 48)
    return {"image_proj": proj, "ip_adapter": ip["ip_adapter"]}


@pytest.mark.parametrize("variant", ["standard", "plus", "full_face"])
def test_ip_adapter_variants_match_jax(variant):
    ip = ip_state_dict(variant, np.random.default_rng(2))
    assert pconv.detect_ip_adapter_variant(ip) == jconv.detect_ip_adapter_variant(ip)
    assert pconv.detect_ip_adapter_variant(ip)[0] == variant
    assert pconv.ip_config_updates(ip) == jconv.ip_config_updates(ip)
    got, want = {}, {}
    pconv._convert_ip_image_proj(ip["image_proj"], variant, got)
    jconv._convert_ip_image_proj(ip["image_proj"], variant, want)
    assert_trees_equal(got, want)


def test_extract_and_merge_match_jax_and_round_trip(sds):
    tree = {"params": jconv.convert_unet(sds["unet"], JCFG.unet, sds["motion"], None, sds["ip"])}
    adapter = pconv.extract_i2v_adapter(tree, PCFG.unet)
    motion = pconv.extract_motion_modules(tree)
    assert_trees_equal(adapter, jconv.extract_i2v_adapter(tree, JCFG.unet))
    assert_trees_equal(motion, jconv.extract_motion_modules(tree))
    # merging the given adapter / motion weights, against JAX
    merged = pconv.merge_i2v_adapter(tree, sds["adapter"], PCFG.unet)
    assert_trees_equal(merged, jconv.merge_i2v_adapter(tree, sds["adapter"], JCFG.unet))
    with_adapter = jconv.convert_unet(sds["unet"], JCFG.unet, sds["motion"], sds["adapter"], sds["ip"])
    assert_trees_equal(merged, with_adapter)
    moved = {k: v * 2 for k, v in sds["motion"].items()}
    assert_trees_equal(pconv.merge_motion_modules(tree, moved, PCFG.unet),
                       jconv.merge_motion_modules(tree, moved, JCFG.unet))
    # round trips: extract after merge gives the state dicts back; merge of
    # an extract is the identity
    assert_trees_equal(pconv.extract_i2v_adapter(merged), sds["adapter"])
    assert_trees_equal(pconv.extract_motion_modules(pconv.merge_motion_modules(tree, moved, PCFG.unet)), moved)
    assert_trees_equal(pconv.merge_i2v_adapter(tree, adapter), tree["params"])
    assert_trees_equal(pconv.merge_motion_modules(tree, motion, PCFG.unet), tree["params"])
    with pytest.raises(ValueError, match="no i2v_adapter keys"):
        pconv.merge_i2v_adapter(tree, sds["motion"])


def st_tensors(rng):
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "bf16": rng.standard_normal((2, 3, 4)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-2**40, 2**40, (4, 2)),
        "i32": rng.integers(-2**20, 2**20, (5,)).astype(np.int32),
        "scalar": np.array(3.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


@pytest.mark.parametrize("direction", ["ours_to_safetensors", "safetensors_to_ours"])
def test_safetensors_io_matches_reference(tmp_path, direction):
    want = st_tensors(np.random.default_rng(3))
    path = str(tmp_path / "t.safetensors")
    if direction == "ours_to_safetensors":
        # bf16 given as a torch tensor, the rest as numpy
        given = dict(want, bf16=torch.from_numpy(want["bf16"].view(np.int16)).view(torch.bfloat16))
        n = safetensors_io.save_file(given, path, metadata={"format": "pt"})
        assert n == os.path.getsize(path)
        got = st_load(path)
    else:
        st_save(want, path)
        got = safetensors_io.load_file(path)
        got["bf16"] = got["bf16"].astype(ml_dtypes.bfloat16)  # widened to float32, exactly
        assert safetensors_io.load_file(path)["bf16"].dtype == np.float32
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert got[k].tobytes() == v.tobytes(), k


def test_safetensors_reader_refuses_bad_files(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    safetensors_io.save_file({"x": np.zeros(4, np.float32)}, path)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-4])  # truncated data
    with pytest.raises(ValueError):
        safetensors_io.load_file(path)
    with pytest.raises(ValueError, match="unsupported"):
        safetensors_io.save_file({"x": np.zeros(2, np.uint8)}, path)


def test_port_writer_matches_synth_layout(tmp_path):
    jdir = synth.write_pretrained_dir(str(tmp_path / "jax"), np.random.default_rng(0))
    info = psynth.write_pretrained_dir(str(tmp_path / "port"), PCFG)
    pdir = str(tmp_path / "port")
    names = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)  # noqa: E731
                                for d, _, fs in os.walk(root) for f in fs)
    assert names(pdir) == names(jdir)
    assert info["bytes"] == sum(os.path.getsize(os.path.join(pdir, n)) for n in names(pdir)
                                if n.endswith((".safetensors", ".bin")))
    layout = lambda sd: {k: (v.shape, v.dtype) for k, v in sd.items()}  # noqa: E731
    for sub in ("unet", "motion_adapter", "vae", "text_encoder", "image_encoder"):
        f = os.path.join(sub, "diffusion_pytorch_model.safetensors")
        assert layout(safetensors_io.load_file(os.path.join(pdir, f))) == layout(st_load(os.path.join(jdir, f)))
    f = os.path.join("ip_adapter", "ip-adapter.bin")
    got, want = (torch.load(os.path.join(d, f), weights_only=True) for d in (pdir, jdir))
    assert {p: {k: (v.shape, v.dtype) for k, v in got[p].items()} for p in got} == \
        {p: {k: (v.shape, v.dtype) for k, v in want[p].items()} for p in want}
    for f in ("tokenizer/vocab.json", "tokenizer/merges.txt", "tokenizer/tokenizer_config.json",
              "model_config.json"):
        assert open(os.path.join(pdir, f)).read() == open(os.path.join(jdir, f)).read(), f
    # fp16 storage and the full-width tokenizer length
    psynth.write_pretrained_dir(str(tmp_path / "half"), PCFG, dtype=np.float16, tokenizer_length=77)
    half = safetensors_io.load_file(str(tmp_path / "half" / "unet" / "diffusion_pytorch_model.safetensors"))
    assert {v.dtype for v in half.values()} == {np.dtype(np.float16)}
    with open(tmp_path / "half" / "tokenizer" / "tokenizer_config.json") as fh:
        assert json.load(fh) == {"model_max_length": 77}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    synth.write_pretrained_dir(str(root / "sd"), np.random.default_rng(0))
    psynth.write_pretrained_dir(str(root / "half"), PCFG, dtype=np.float16, seed=4)
    psynth.write_pretrained_dir(str(root / "ff"), FF_PCFG, seed=5)
    adapter = psynth.write_adapter_task(str(root / "checkpoint"), "task", PCFG)
    ips = {}
    for i, variant in enumerate(("plus", "full_face")):  # the tiny plus head: 6 x 12, depth 2
        ip_sd = psynth.make_ip_adapter_sd(psynth.Draw(30 + i), PCFG, variant, num_tokens=6, resampler_dim=12,
                                          depth=2)
        ips[variant] = str(root / f"ip-{variant}.bin")
        psynth.save_ip_adapter(ip_sd, ips[variant])
    return {"dir": str(root / "sd"), "half": str(root / "half"), "ff": str(root / "ff"), "adapter": adapter,
            "ip": ips}


PIPE_ARGS = dict(num_frames=2, height=32, width=32, num_inference_steps=2, blur_sigma=1.0)


@pytest.mark.parametrize("dtype,adapter,directory", [
    ("float32", False, "dir"), ("float32", True, "dir"), ("bfloat16", False, "dir"),
    ("bfloat16", True, "dir"), ("bfloat16", False, "half"), ("float32", True, "plus"),
    ("bfloat16", False, "full_face")])
def test_from_pretrained_matches_jax(ckpt, dtype, adapter, directory):
    """Bit for bit: each port module equals ``load_flax_params`` of the JAX
    tree in the pipeline's dtype.  The JAX package stores an fp32 leaf in
    bf16 under a bf16 pipeline and keeps an fp16 leaf in fp16; the port
    stores every leaf in the compute dtype, which for fp32 files is the same
    rounding (the 'half' case holds the port's rule).  'plus' and
    'full_face' load a directory with such an IP-Adapter file ('full_face'
    one whose image encoder gives the head's 257 tokens)."""
    path = ckpt["adapter"] if adapter else None
    root, ip = (ckpt["dir"], ckpt["ip"][directory]) if directory in ckpt["ip"] else (ckpt[directory], None)
    jcfg, pcfg = (FF_JCFG, FF_PCFG) if directory == "full_face" else (JCFG, PCFG)
    root = ckpt["ff"] if directory == "full_face" else root
    jpipe = JPipeline.from_pretrained(root, model_config=jcfg, pipeline_config=JPipelineConfig(dtype=dtype),
                                      i2v_adapter_path=path, ip_adapter_path=ip)
    pipe = I2VAdapterPipeline.from_pretrained(root, model_config=pcfg, pipeline_config=PipelineConfig(dtype=dtype),
                                              i2v_adapter_path=path, ip_adapter_path=ip, device="cpu")
    assert pipe.config.unet.ip_variant == (directory if ip else "standard")
    torch_dtype = getattr(torch, dtype)
    for name, cls in MODULES.items():
        module = cls(getattr(pipe.config, name), device="cpu")
        want = pconv.load_flax_params(module, jpipe.params[name]).to(torch_dtype).state_dict()
        got = getattr(pipe, name).state_dict()
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == torch_dtype and torch.equal(got[k], want[k]), (name, k)
    adapter_out = pipe.unet.state_dict()["down_blocks_0.attentions_0.transformer_blocks_0.i2v_adapter.to_out.weight"]
    assert bool(adapter_out.any()) == adapter
    prompts = ["a cat", "a dog", ""]
    np.testing.assert_array_equal(pipe.tokenizer(prompts), jpipe.tokenizer(prompts))
    assert pipe.config.unet.to_dict() == jpipe.config.unet.to_dict()


def test_from_pretrained_latents_equal_pipeline_from_jax_tree(ckpt):
    pc = PipelineConfig(dtype="float32", **PIPE_ARGS)
    pipe = I2VAdapterPipeline.from_pretrained(ckpt["dir"], model_config=EXACT_PCFG, pipeline_config=pc,
                                              i2v_adapter_path=ckpt["adapter"], device="cpu")
    jpipe = JPipeline.from_pretrained(ckpt["dir"], model_config=JCFG,
                                      pipeline_config=JPipelineConfig(dtype="float32"),
                                      i2v_adapter_path=ckpt["adapter"])
    from_tree = I2VAdapterPipeline(EXACT_PCFG, jpipe.params, pipe.tokenizer, pc, device="cpu")
    image = np.random.default_rng(5).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    got = pipe("a cat", condition_image=image, seed=1, output_type="latent")
    want = from_tree("a cat", condition_image=image, seed=1, output_type="latent")
    assert np.isfinite(got).all() and got.shape == (1, 2, 16, 16, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["plus_ip_head", "missing_vae"])
def test_from_pretrained_refusals(ckpt, tmp_path, case):
    """A plus IP-Adapter head that reads hidden states of another width than
    the image encoder's (24 against 16 here) is refused before the UNet is
    read; a directory without a required model's weights names the
    folder."""
    if case == "plus_ip_head":
        plus = str(tmp_path / "ip-plus.bin")
        ip = ip_state_dict("plus", np.random.default_rng(6))
        torch.save({p: {k: torch.from_numpy(v) for k, v in ip[p].items()} for p in ip}, plus)
        with pytest.raises(ValueError, match="plus head reads 24-wide hidden states, the image encoder gives 16"):
            I2VAdapterPipeline.from_pretrained(ckpt["dir"], model_config=PCFG, ip_adapter_path=plus,
                                               device="cpu")
        return
    root = shutil.copytree(ckpt["dir"], str(tmp_path / "sd"))
    shutil.rmtree(os.path.join(root, "vae"))
    with pytest.raises(FileNotFoundError, match="vae"):
        I2VAdapterPipeline.from_pretrained(root, model_config=PCFG, device="cpu")
