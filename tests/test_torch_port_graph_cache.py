"""The ``'scan'`` step graphs kept across calls (the port's counterpart of
the JAX package's ``_sampler_cache``), at the tiny config on the CPU, fp32,
where the kept ``StepGraphs`` runs its static-buffer program eagerly:

* a second identical ``'scan'`` call builds nothing (a hit, the build
  counter unchanged) and gives the first call's clip and ``'stepwise'``'s
  bit for bit; another step count reuses the entry; another frame count or
  guidance builds a new one;
* the invalidation points: each of the calls where the JAX package clears
  its ``_sampler_cache`` empties the port's cache at the same calls (the
  JAX pipeline driven through the same sequence with a dummy key in its
  cache, ``enable_mesh`` / ``disable_mesh`` included, on a one-device
  mesh); a re-quantisation of the int8 weights; the trainer's validation
  swap (``training.driver._run_validation``) leaves no entry; an in-place
  weight write nobody announced makes the next call build afresh, its clip
  equal to ``'stepwise'``'s;
* the memory rule: least recently used entries dropped first, and a
  request whose pool would not fit beside its decode captured for the call
  only; a pipeline with kept graphs is freed as soon as its last reference
  goes (no reference cycle holds it, and its graphs' pools, for the cyclic
  collector).
"""

import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.config import MeshConfig as JMeshConfig
from i2v_adapter_tpu.config import tiny_test_config as j_tiny
from i2v_adapter_tpu.parallel import mesh as jmesh
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.utils.tokenizer import make_test_tokenizer as j_make_test_tokenizer
from i2v_adapter_tpu_torch.config import PipelineConfig
from i2v_adapter_tpu_torch.models.layers import int8_sites
from i2v_adapter_tpu_torch.parallel import mesh as pmesh
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.training import driver as pdriver
from i2v_adapter_tpu_torch.utils.convert import to_flax_tree
from i2v_adapter_tpu_torch.utils.random_init import random_pipeline
from i2v_adapter_tpu_torch.utils.safetensors_io import save_file
from i2v_adapter_tpu_torch.utils.tokenizer import make_test_tokenizer
from tests.test_torch_port_scan import SIZE, _lora_sd, _pcfg
from tests.torch_port_common import one_torch_thread  # noqa: F401

IMAGE = np.random.default_rng(2).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)


def _pipe(int8=False, seed=3, cfg=None):
    pc = PipelineConfig(num_frames=2, height=SIZE, width=SIZE, num_inference_steps=4, blur_sigma=1.0,
                        dtype="float32", int8_conv=int8)
    return random_pipeline(cfg or _pcfg(), pc, "cpu", seed=seed)


def _call(p, dispatch="scan", **kw):
    kw = dict(dict(condition_image=IMAGE, seed=7, output_type="latent"), **kw)
    return p("a cat", dispatch=dispatch, **kw)


def _builds(p):
    return p.last_dispatch["graph_cache"]["builds"]


@pytest.fixture(scope="module")
def pipe():
    return _pipe()


def test_repeated_call_replays_the_kept_entry(pipe):
    pipe.release_graphs()
    first = _call(pipe)
    cache = pipe.last_dispatch["graph_cache"]
    assert not cache["hit"] and cache["kept"] and cache["entries"] == 1
    builds = _builds(pipe)
    again = _call(pipe)
    assert pipe.last_dispatch["graph_cache"]["hit"] and _builds(pipe) == builds
    assert pipe.last_dispatch["capture_ms"] == []  # nothing captured on a hit (none on the CPU at all)
    stepwise = _call(pipe, dispatch="stepwise")
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(again, stepwise)
    # decoded too: the kept latents buffer is not what the call hands out
    video = _call(pipe, output_type="np")
    assert pipe.last_dispatch["graph_cache"]["hit"]
    np.testing.assert_array_equal(video, _call(pipe, dispatch="stepwise", output_type="np"))


def test_another_step_count_reuses_the_entry(pipe):
    pipe.release_graphs()
    _call(pipe, num_inference_steps=4)
    builds = _builds(pipe)
    for steps, strength in ((6, None), (3, 0.7)):
        got = _call(pipe, num_inference_steps=steps, frame_similarity_sample_ratio=strength)
        assert pipe.last_dispatch["graph_cache"]["hit"] and _builds(pipe) == builds
        assert len(pipe.last_timings["step_ms"]) == len(pipe._build_parts(
            1, 2, SIZE, SIZE, steps, strength or pipe.pipe_config.frame_similarity_sample_ratio, 7.5, True,
            True)[3])
        np.testing.assert_array_equal(got, _call(pipe, dispatch="stepwise", num_inference_steps=steps,
                                                 frame_similarity_sample_ratio=strength))
    assert pipe.last_dispatch == {"dispatch": "stepwise"}


@pytest.mark.parametrize("change", ["frames", "guidance", "encoder_cache", "cfg_cutoff"])
def test_another_bucket_builds_a_new_entry(pipe, change):
    kw = {"frames": dict(num_frames=3), "guidance": dict(guidance_scale=5.0),
          "encoder_cache": dict(encoder_cache=2), "cfg_cutoff": dict(cfg_cutoff=0.5, num_inference_steps=4)}[change]
    pipe.release_graphs()
    _call(pipe)
    builds = _builds(pipe)
    got = _call(pipe, **kw)
    cache = pipe.last_dispatch["graph_cache"]
    assert not cache["hit"] and _builds(pipe) == builds + 1 and cache["entries"] == 2
    np.testing.assert_array_equal(got, _call(pipe, dispatch="stepwise", **kw))
    _call(pipe)  # the first bucket is still kept
    assert pipe.last_dispatch["graph_cache"]["hit"] and _builds(pipe) == builds + 1


# ---------------------------------------------------------------------------
# invalidation
# ---------------------------------------------------------------------------


INVALIDATIONS = ("enable_freeu", "disable_freeu", "enable_int8_conv", "disable_int8_conv", "load_lora_weights",
                 "load_textual_inversion", "enable_mesh", "disable_mesh")


def test_invalidation_points_match_jax(tmp_path):
    """Each of the JAX pipeline's cache-clearing calls, on both packages,
    with a key in each cache before it: both caches empty after the same
    calls (the mesh calls last, on a one-device mesh of each package: a LoRA
    merges before ``enable_mesh``)."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    tok, jtok = make_test_tokenizer(str(tmp_path / "p")), j_make_test_tokenizer(str(tmp_path / "j"))
    cfg = _pcfg()
    cfg = cfg.replace(text_encoder=cfg.text_encoder.replace(vocab_size=len(tok.encoder)))
    p = _pipe(seed=4, cfg=cfg)
    p.tokenizer = tok
    jp = JPipeline.__new__(JPipeline)
    jp.config = j_tiny().replace(text_encoder=j_tiny().text_encoder.replace(vocab_size=len(tok.encoder)))
    jp.dtype, jp.mesh, jp.tokenizer = jnp.float32, None, jtok
    jp.params = {"unet": {"params": to_flax_tree(p.unet)}, "text_encoder": {"params": to_flax_tree(p.text_encoder)}}
    lora = str(tmp_path / "lora.safetensors")
    save_file(_lora_sd(p.unet, "peft", np.random.default_rng(1)), lora)
    emb = str(tmp_path / "emb.safetensors")
    save_file({"<sks>": np.random.default_rng(9).standard_normal((2, cfg.text_encoder.hidden_size))
               .astype(np.float32)}, emb)
    calls = {"enable_freeu": lambda q: q.enable_freeu(), "disable_freeu": lambda q: q.disable_freeu(),
             "enable_int8_conv": lambda q: q.enable_int8_conv(True),
             "disable_int8_conv": lambda q: q.enable_int8_conv(False),
             "load_lora_weights": lambda q: q.load_lora_weights(lora, scale=0.5),
             "load_textual_inversion": lambda q: q.load_textual_inversion(emb, "<sks>"),
             "enable_mesh": lambda q: q.enable_mesh(meshes[q is p]), "disable_mesh": lambda q: q.disable_mesh()}
    meshes = {True: pmesh.Mesh({"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}, 0, p.device, {}),
              False: jmesh.create_mesh(JMeshConfig(data=1, fsdp=1, tensor=1, seq=1), jax.devices()[:1])}
    cleared = {"port": [], "jax": []}
    for name in INVALIDATIONS:
        p._graph_cache()[("dummy",)] = types.SimpleNamespace(pool_bytes=0)
        jp.__dict__.setdefault("_sampler_cache", {})[("dummy",)] = None
        calls[name](p)
        calls[name](jp)
        cleared["port"].append(not p._graph_cache())
        cleared["jax"].append(not jp._sampler_cache)
    assert cleared["port"] == cleared["jax"] == [True] * len(INVALIDATIONS)
    # a real entry too: kept, then dropped by a clearing call, then rebuilt
    _call(p)
    assert p.last_dispatch["graph_cache"]["kept"]
    p.enable_freeu()
    assert not p._graph_cache()
    got = _call(p)
    assert not p.last_dispatch["graph_cache"]["hit"]
    np.testing.assert_array_equal(got, _call(p, dispatch="stepwise"))


def test_requantisation_drops_the_graphs():
    """The int8 weights quantised again (new ``(wq, ws)`` tensors a kept
    graph would not read) drop the kept entries; a call with nothing to
    quantise keeps them."""
    p = _pipe(int8=True)
    _call(p)
    assert p.prepare_int8() == 0 and len(p._graph_cache()) == 1
    with torch.no_grad():
        int8_sites(p.unet)[2].weight.mul_(1.5)
    assert p.prepare_int8() == 1 and not p._graph_cache()
    got = _call(p)
    assert not p.last_dispatch["graph_cache"]["hit"]
    np.testing.assert_array_equal(got, _call(p, dispatch="stepwise"))


def test_unannounced_weight_write_recaptures():
    """An in-place write to a UNet weight nobody announced: the fingerprint
    of the UNet's parameters drops the kept entry, the next call builds
    afresh and reads the new weights."""
    p = _pipe()
    before = _call(p)
    builds = _builds(p)
    weight = dict(p.unet.named_parameters())["conv_out.weight"]
    with torch.no_grad():
        weight.mul_(1.25)
    got = _call(p)
    assert not p.last_dispatch["graph_cache"]["hit"] and _builds(p) == builds + 1
    assert not np.array_equal(got, before)
    np.testing.assert_array_equal(got, _call(p, dispatch="stepwise"))
    # a replaced storage (.data swapped) too
    weight.data = weight.data.clone()
    _call(p)
    assert not p.last_dispatch["graph_cache"]["hit"]


def test_validation_swap_leaves_no_stale_entry(tmp_path, monkeypatch):
    """The trainer's validation swaps the trained weights in (``.data``)
    and back: no entry outlives it, and the next call runs on the master
    weights, equal to ``'stepwise'``."""
    from PIL import Image

    p = _pipe()
    want = _call(p, dispatch="stepwise")
    _call(p)
    assert len(p._graph_cache()) == 1
    image = str(tmp_path / "cond.png")
    Image.fromarray(IMAGE).save(image)
    csv_path = str(tmp_path / "eval.csv")
    with open(csv_path, "w") as f:
        f.write(f"prompt,image_path\na cat,{image}\n")
    named = dict(p.unet.named_parameters())
    trainable = ["conv_out.weight", "conv_out.bias"]
    trained = {n: named[n].detach() * 1.5 for n in trainable}
    state = types.SimpleNamespace(ema=None, unet=p.unet, trainable=trainable, trainable_params=lambda: trained)
    args = types.SimpleNamespace(eval_csv_path=csv_path, n_frames=2, resolution=SIZE)
    pcalls = []
    real = I2VAdapterPipeline.__call__

    def recording(self, *a, **k):
        out = real(self, *a, **k)
        pcalls.append(dict(self.last_dispatch))
        return out

    monkeypatch.setattr(I2VAdapterPipeline, "__call__", recording)
    videos = pdriver._run_validation(args, p, state, _pcfg(), str(tmp_path), 0)
    assert len(videos) == 1 and pcalls[0]["dispatch"] == "scan"
    assert not pcalls[0]["graph_cache"]["hit"]  # built on the trained weights
    assert not p._graph_cache()
    got = _call(p)
    assert not p.last_dispatch["graph_cache"]["hit"]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the memory rule
# ---------------------------------------------------------------------------


def test_trim_drops_least_recently_used_first(pipe):
    pipe.release_graphs()
    cache = pipe._graph_cache()
    for name, size in (("a", 3), ("b", 5), ("c", 4)):
        cache[(name,)] = types.SimpleNamespace(pool_bytes=size)
    cache.move_to_end(("a",))  # used last
    pipe._trim_graphs(9, spare=("b",))  # b spared: c (4) + a (3) fit
    assert list(cache) == [("b",), ("c",), ("a",)]
    pipe._trim_graphs(8)  # b dropped first; c + a = 7
    assert list(cache) == [("c",), ("a",)]
    pipe._trim_graphs(3)
    assert list(cache) == [("a",)]
    pipe._trim_graphs(0)
    assert not cache
    # the rooms a request leaves: the decode envelope's bytes less its own
    room = pipe.MAX_DECODE_TOKENS * pipe.DECODE_TOKEN_BYTES
    assert pipe._graph_rooms(0, 0, 0) == (min(pipe.MAX_KEPT_GRAPH_BYTES, room),) * 2
    assert pipe._graph_rooms(10, 7, pipe.MAX_DECODE_TOKENS) == (
        min(pipe.MAX_KEPT_GRAPH_BYTES, room - 20 * pipe.EVAL_TOKEN_BYTES - 7), 0)


def test_request_over_the_budget_is_not_kept(pipe, monkeypatch):
    pipe.release_graphs()
    monkeypatch.setattr(I2VAdapterPipeline, "MAX_KEPT_GRAPH_BYTES", 0)
    got = _call(pipe)
    cache = pipe.last_dispatch["graph_cache"]
    assert not cache["kept"] and cache["entries"] == 0 and not pipe._graph_cache()
    np.testing.assert_array_equal(got, _call(pipe, dispatch="stepwise"))


def test_a_dropped_pipeline_frees_its_kept_graphs():
    """Kept graphs do not refer back to their pipeline: with the cyclic
    collector off, dropping the last reference to a pipeline frees it and
    its kept entries at once."""
    p = _pipe()
    _call(p)
    _call(p, encoder_cache=2)
    assert len(p._graph_cache()) == 2
    gone = [weakref.ref(p), *(weakref.ref(entry) for entry in p._graph_cache().values())]
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        del p
        assert all(ref() is None for ref in gone)
    finally:
        if enabled:
            gc.enable()
