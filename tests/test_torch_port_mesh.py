"""Serving one clip over a mesh, on the CPU: the port's ranks over gloo
(spawned by ``parallel.launch.run_ranks``; their code in
``tests/torch_port_mesh_workers.py``, which imports no JAX) against the JAX
package on the 8-device CPU mesh of ``tests/conftest.py``.

* ``create_mesh``'s rank layout and axis groups against the JAX device
  reshape; ``fsdp_spec`` and ``_tp_spec`` / ``tp_param_shardings`` against
  the JAX rules, the latter on the tiny UNet's parameter paths;
* the three flash layouts (self, cross-frame with one clip per shard,
  several clips per shard), both temporal layouts (tokens split, and S
  odd: frames split with K/V gathered), the 3x3 conv and K4's fused conv on
  a slab, the motion GroupNorm: the port at (2,1,2) and (1,2,2) against the
  JAX ``parallel.spmd`` path at (2,2,2), 1e-5 of the output's scale
  (``maxerr``) in fp32;
* the tiny pipeline (fp32, exact convs) at (2,1,2) and (1,2,2), stepwise
  and scan, against the JAX single-device loop at ``atol=5e-4``
  (``tests/test_parallel_infer.py``'s bound for JAX's own mesh); a clip in
  temporal windows at (2,1,2) against the unmeshed one;
* every int8 site's activation scale inside the mesh's layout equal to the
  unmeshed one bit for bit, teacher-forced;
* the memory envelopes scale with data x seq;
* the daemon with ``--mesh 2,1,1`` on two ranks: two requests equal to the
  unmeshed daemon's, a failing request failed on both ranks between them;
* the audit: one step's and one decode's collectives equal
  ``collectives_per_unet_eval`` / ``collectives_per_decode``;
  ``audit_multichip --case train`` is refused.
"""

import json
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2v_adapter_tpu.config import MeshConfig as JMeshConfig
from i2v_adapter_tpu.config import PipelineConfig as JPipelineConfig
from i2v_adapter_tpu.config import tiny_test_config as j_tiny
from i2v_adapter_tpu.models import AutoencoderKL as JVAE
from i2v_adapter_tpu.models import CLIPTextEncoder as JText
from i2v_adapter_tpu.models import CLIPVisionEncoder as JVision
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.models.layers import group_norm as j_group_norm
from i2v_adapter_tpu.ops.attention import dot_product_attention as j_attention
from i2v_adapter_tpu.ops.attention import temporal_attention as j_temporal
from i2v_adapter_tpu.ops.conv3x3 import conv3x3_pallas
from i2v_adapter_tpu.ops.conv3x3 import gn_silu_conv3x3 as j_gn_silu_conv3x3
from i2v_adapter_tpu.parallel import mesh as jmesh
from i2v_adapter_tpu.parallel import spmd as jspmd
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.schedulers import make_schedule as j_make_schedule
from i2v_adapter_tpu_torch.config import MeshConfig, PipelineConfig, tiny_test_config
from i2v_adapter_tpu_torch.models import AutoencoderKL, VideoUNet
from i2v_adapter_tpu_torch.parallel import audit, launch, spmd
from i2v_adapter_tpu_torch.parallel import mesh as pmesh
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline, serve
from i2v_adapter_tpu_torch.utils.convert import to_flax_tree
from tests import synth
from tests import torch_port_mesh_workers as workers
from tests.torch_port_common import maxerr, one_torch_thread, random_params  # noqa: F401

B, F, LAT, STEPS, GUIDANCE = 1, 4, 10, 2, 7.5
EXACT = dict(flash_attention=False, fast_gelu=False, flash_static_max=0.0)
# spawned gloo ranks are bounded, so a hang fails the test instead of the run
RANKS_TIMEOUT_S = 240


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def mesh222():
    return jmesh.create_mesh(JMeshConfig(data=2, fsdp=1, tensor=2, seq=2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 4 gloo ranks: every module check and the pipeline checks
    (rank 0's results; every rank gathered the same)."""
    rng = np.random.default_rng(0)
    mod = {
        "q": _rand(rng, (8, 64, 4, 8)), "k": _rand(rng, (8, 64, 4, 8)), "v": _rand(rng, (8, 64, 4, 8)),
        "k1": _rand(rng, (2, 64, 4, 8)), "v1": _rand(rng, (2, 64, 4, 8)),
        "qm": _rand(rng, (16, 32, 4, 8)), "km": _rand(rng, (4, 32, 4, 8)), "vm": _rand(rng, (4, 32, 4, 8)),
        "tq": _rand(rng, (2, 4, 16, 32)), "tk": _rand(rng, (2, 4, 16, 32)), "tv": _rand(rng, (2, 4, 16, 32)),
        "fq": _rand(rng, (2, 4, 15, 32)), "fk": _rand(rng, (2, 4, 15, 32)), "fv": _rand(rng, (2, 4, 15, 32)),
        "gx": _rand(rng, (2, 4, 16, 32)), "gw": 1 + 0.1 * _rand(rng, (32,)), "gb": 0.1 * _rand(rng, (32,)),
        "cx": _rand(rng, (4, 8, 8, 128)), "ck": _rand(rng, (3, 3, 128, 128)) / 20, "cb": _rand(rng, (128,)),
    }
    jcfg = j_tiny()
    jcfg = jcfg.replace(unet=jcfg.unet.replace(**EXACT))
    size = LAT * jcfg.vae.spatial_scale_factor
    ucfg = jcfg.unet
    params = {
        "unet": random_params(
            JUNet(ucfg), jnp.zeros((1, F, LAT, LAT, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 7, ucfg.cross_attention_dim)), jnp.zeros((1, ucfg.image_embed_dim)),
            seed=1, enable_cross_frame_attn=True),
        "vae": random_params(JVAE(jcfg.vae), jnp.zeros((1, size, size, 3)), seed=2),
        "text_encoder": random_params(JText(jcfg.text_encoder), jnp.zeros((1, 16), jnp.int32), seed=3),
        "image_encoder": random_params(
            JVision(jcfg.image_encoder),
            jnp.zeros((1, jcfg.image_encoder.image_size, jcfg.image_encoder.image_size, 3)), seed=4),
    }
    params_path = str(tmp_path_factory.mktemp("mesh") / "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump(params, f)
    pipe_in = {
        "latents0": _rand(rng, (B, F, LAT, LAT, 4)),
        "cond_latents": _rand(rng, (B, LAT, LAT, 4)),
        "text_states": 0.5 * _rand(rng, (2 * B, 16, ucfg.cross_attention_dim)),
        "image_embeds": _rand(rng, (2 * B, ucfg.image_embed_dim)),
    }
    pipe_kwargs = dict(num_frames=F, height=size, width=size, num_inference_steps=STEPS, blur_sigma=1.0,
                       dtype="float32")
    out = launch.run_ranks(workers.all_checks, 4, (mod, params_path, pipe_kwargs, pipe_in, STEPS, GUIDANCE),
                           device="cpu", timeout=RANKS_TIMEOUT_S)
    for rank in out[1:]:  # every rank holds the gathered outputs
        for key, value in rank["modules"].items():
            np.testing.assert_array_equal(value, out[0]["modules"][key])
    return {"mod": mod, "params": params, "pipe_in": pipe_in, "jcfg": jcfg, "size": size, "out": out[0]}


# ---------------------------------------------------------------------------
# the mesh's layout and rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(2, 1, 1, 2), (1, 1, 2, 2), (2, 1, 2, 1), (-1, 1, 1, 2), (1, 2, 2, 2)])
def test_create_mesh_rank_layout_matches_jax(sizes):
    """Rank r sits where JAX device r sits in the reshaped device array, and
    each axis group holds the ranks JAX's axis does."""
    cfg = dict(zip(("data", "fsdp", "tensor", "seq"), sizes))
    n = 8 if -1 in sizes else int(np.prod(sizes))
    jm = jmesh.create_mesh(JMeshConfig(**cfg), jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    shape = pmesh.mesh_shape(MeshConfig(**cfg), n)
    assert shape == tuple(jm.devices.shape)
    for r in range(n):
        m = pmesh.Mesh(dict(zip(pmesh.AXES, shape)), r, torch.device("cpu"), {})
        assert ids[tuple(m.coords[a] for a in pmesh.AXES)] == jax.devices()[r].id
    for axes in pmesh.GROUP_AXES:
        keep = [pmesh.AXES.index(a) for a in axes]
        rest = [i for i in range(4) if i not in keep]
        want = sorted(sorted(row.tolist()) for row in np.transpose(ids, rest + keep).reshape(-1, ids[
            tuple(slice(None) if i in keep else 0 for i in range(4))].size))
        assert sorted(pmesh.group_ranks(shape, axes)) == want
    with pytest.raises(ValueError, match="at most one"):
        pmesh.mesh_shape(MeshConfig(data=-1, seq=-1), 8)
    with pytest.raises(ValueError, match="devices"):
        pmesh.mesh_shape(MeshConfig(data=3, seq=1), 8)


@pytest.mark.parametrize("shape,fsdp", [((320, 320), 2), ((4, 4), 2), ((3, 3, 320, 640), 4), ((1280, 7), 8)])
def test_fsdp_spec_matches_jax(shape, fsdp):
    assert pmesh.fsdp_spec(shape, fsdp) == tuple(jmesh.fsdp_spec(shape, fsdp))
    assert pmesh.fsdp_spec(shape, fsdp, min_size=1) == tuple(jmesh.fsdp_spec(shape, fsdp, min_size=1))


def test_tp_spec_matches_jax_on_tiny_unet():
    """``tp_param_shardings`` of the port's tiny UNet equals the JAX rules
    on the same parameters' Flax tree, leaf by leaf."""
    unet = VideoUNet(tiny_test_config().unet, device="cpu")
    tree = {"params": to_flax_tree(unet)}
    jm = jmesh.create_mesh(JMeshConfig(data=4, fsdp=1, tensor=2, seq=1))
    want = jax.tree_util.tree_leaves_with_path(jspmd.tp_param_shardings(tree, jm))
    got = spmd.tp_param_shardings(unet, 2)
    from i2v_adapter_tpu_torch.utils.convert import flax_leaf

    modules = dict(unet.named_modules())
    by_path = {tuple(flax_leaf(modules, name)[0]): spec for name, spec in got.items()}
    assert len(by_path) == len(want)
    sharded = 0
    for path, sharding in want:
        keys = tuple(str(getattr(k, "key", k)) for k in path)[1:]
        assert by_path[keys] == tuple(sharding.spec), keys
        sharded += bool(by_path[keys])
    assert sharded > 0
    assert all(spec == () for spec in spmd.tp_param_shardings(unet, 1).values())
    vae = AutoencoderKL(tiny_test_config().vae, device="cpu")
    specs = spmd.pipeline_param_shardings({"unet": unet, "vae": vae, "image_encoder": None}, 2)
    assert specs["unet"] == got and set(specs) == {"unet", "vae"}
    assert all(spec == () for spec in specs["vae"].values())


# ---------------------------------------------------------------------------
# the sites, against the JAX spmd path
# ---------------------------------------------------------------------------


def _jax_site(name, mod, mesh):
    a = {k: jnp.asarray(v) for k, v in mod.items()}
    if name == "temporal_frames":
        # the JAX frame-sharded layout reaches its einsum path below 128
        # tokens, which takes no fewer query frames than K/V frames: the
        # reference is the unsharded function
        return j_temporal(a["fq"], a["fk"], a["fv"], heads=4, impl="xla")
    with mesh, jspmd.attention_spmd(mesh):
        if name == "flash_self":
            return jax.jit(lambda q, k, v: j_attention(q, k, v, impl="pallas_interpret"))(a["q"], a["k"], a["v"])
        if name == "flash_cross":
            return jax.jit(lambda q, k, v: j_attention(q, k, v, kv_repeat=4, impl="pallas_interpret"))(
                a["q"], a["k1"], a["v1"])
        if name == "flash_multiclip":
            return jax.jit(lambda q, k, v: j_attention(q, k, v, kv_repeat=4, impl="pallas_interpret"))(
                a["qm"], a["km"], a["vm"])
        if name == "temporal_tokens":
            return jax.jit(lambda q, k, v: j_temporal(q, k, v, heads=4, impl="pallas_cs_interpret"))(
                a["tq"], a["tk"], a["tv"])
        if name == "motion_norm":
            x = a["gx"].reshape(2, -1, 32)
            gn = j_group_norm(8, 1e-6, jnp.float32, "norm")
            y = gn.apply({"params": {"scale": a["gw"], "bias": a["gb"]}}, x)
            return y.reshape(a["gx"].shape)
        ctx = jspmd.current_attention_spmd()
        if name == "conv":
            return jspmd.spmd_conv3x3(lambda x, k, b: conv3x3_pallas(x, k, b, interpret=True),
                                      a["cx"], a["ck"], a["cb"], ctx)
        s = jnp.full((4, 128), 0.5), jnp.full((4, 128), 0.1)
        return jspmd.spmd_gn_silu_conv3x3(
            lambda x, p, q, k, b: j_gn_silu_conv3x3(x, p, q, k, b, True),
            a["cx"], s[0], s[1], a["ck"], a["cb"], ctx)


SITES = ("flash_self", "flash_cross", "flash_multiclip", "temporal_tokens", "temporal_frames", "motion_norm",
         "conv", "gn_conv")


@pytest.mark.parametrize("mesh_name", sorted(workers.MESHES))
@pytest.mark.parametrize("site", SITES)
def test_spmd_site_matches_jax(runs, mesh222, site, mesh_name):
    want = np.asarray(_jax_site(site, runs["mod"], mesh222))
    got = runs["out"]["modules"][f"{site}/{mesh_name}"]
    assert got.shape == want.shape
    assert maxerr(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_clip(runs):
    """The JAX single-device denoise loop and decode on the fed inputs."""
    jcfg, size, inp = runs["jcfg"], runs["size"], runs["pipe_in"]
    jp = JPipeline.__new__(JPipeline)
    jp.config, jp.dtype, jp.mesh = jcfg, jnp.float32, None
    jp.pipe_config = JPipelineConfig(num_frames=F, height=size, width=size, num_inference_steps=STEPS,
                                     dtype="float32", blur_sigma=1.0, int8_conv=False)
    jp.unet, jp.vae = JUNet(jcfg.unet), JVAE(jcfg.vae)
    jp.text_encoder, jp.image_encoder = JText(jcfg.text_encoder), JVision(jcfg.image_encoder)
    jp.schedule = j_make_schedule(jcfg.scheduler)
    _, step, decode, ts, prev, _ = jp._build_parts(B, F, size, size, STEPS, 1.0, GUIDANCE, True, True, 0, False, 1)
    params = {k: runs["params"][k] for k in ("unet", "vae")}
    consts = tuple(jnp.asarray(inp[k]) for k in ("cond_latents", "text_states", "image_embeds"))
    carry = (jnp.asarray(inp["latents0"]), jax.random.PRNGKey(0))
    step = jax.jit(step)
    for t, tp in zip(ts, prev):
        carry = step(params, consts, carry, jnp.asarray(t), jnp.asarray(tp))
    return np.asarray(jax.jit(decode)(params, consts, carry[0])).reshape(B, F, size, size, 3)


@pytest.mark.parametrize("dispatch", ["stepwise", "scan"])
@pytest.mark.parametrize("mesh_name", sorted(workers.MESHES))
def test_pipeline_mesh_matches_jax_single_device(runs, jax_clip, mesh_name, dispatch):
    """The meshed clip (the motion modules token-sharded at 100 tokens and
    frame-sharded at 25, heads split at (1,2,2)) against the JAX
    single-device clip; the unmeshed port clip too, and again after
    ``disable_mesh``."""
    out = runs["out"]
    np.testing.assert_allclose(out[f"{mesh_name}/{dispatch}"], jax_clip, atol=5e-4, rtol=0)
    np.testing.assert_allclose(out["unmeshed"], jax_clip, atol=5e-4, rtol=0)
    np.testing.assert_array_equal(out["unmeshed_again"], out["unmeshed"])


def test_tiled_clip_over_mesh(runs):
    """A 12-frame clip past the tiny motion cap, in anchored temporal
    windows: the 7-frame first window runs whole over seq, the 8-frame
    anchored ones split; equal to the unmeshed port's tiled clip."""
    out = runs["out"]
    assert out["tiled/unmeshed"].shape == (B, 12, runs["size"], runs["size"], 3)
    np.testing.assert_allclose(out["tiled/2,1,2"], out["tiled/unmeshed"], atol=5e-4, rtol=0)


def test_int8_scales_equal_unmeshed(runs):
    scales = runs["out"]["int8_scales"]
    assert scales["unet_sites"] > 0 and len(scales["whole"]) > scales["unet_sites"]
    assert scales["meshed"] == scales["whole"]


def test_mesh_envelopes_scale():
    """The UNet and encoder-cache envelopes scale with data x seq (the JAX
    ``test_pipeline_mesh_envelope_scales``); tensor does not split the
    working set."""
    pipe = I2VAdapterPipeline.__new__(I2VAdapterPipeline)
    pipe.config, pipe.pipe_config, pipe.mesh = tiny_test_config(), PipelineConfig(dtype="float32"), None
    evals = 1024  # x 4096 tokens at 128 px: past one card's envelope, within four's
    with pytest.raises(ValueError, match="memory envelope"):
        pipe._check_memory_envelope(evals, 128, 128, 8)
    shape = {"data": 2, "fsdp": 1, "tensor": 1, "seq": 2}
    pipe.mesh = pmesh.Mesh(shape, 0, torch.device("cpu"), {})
    pipe._check_memory_envelope(evals, 128, 128, 8)
    pipe.mesh = pmesh.Mesh(dict(shape, data=1, tensor=4, seq=1), 0, torch.device("cpu"), {})
    with pytest.raises(ValueError, match="memory envelope"):
        pipe._check_memory_envelope(evals, 128, 128, 8)


def test_audit_counts_equal_formula(runs):
    """One CFG step's and one decode's collectives at (2,1,2) under int8
    (rows 2 over data, frames 4 over seq; motion tokens 100 split, 25 not)
    equal the formulas written beside the audit."""
    a = runs["out"]["audit"]
    ucfg = tiny_test_config().unet
    want = audit.collectives_per_unet_eval(ucfg, a["mesh"], 2 * B, F, LAT, cross_frame=True, int8=True)
    got = {k: v["count"] for k, v in a["step"]["by_kind"].items()}
    assert got == want
    assert set(want) == {"all-gather", "all-to-all", "all-reduce", "collective-broadcast"}
    want = audit.collectives_per_decode(tiny_test_config().vae, a["mesh"], B * F, int8=True)
    assert {k: v["count"] for k, v in a["decode"]["by_kind"].items()} == want
    assert a["step"]["wire_bytes_per_device"] > 0


def test_audit_train_case_waits_for_training_over_a_mesh():
    from i2v_adapter_tpu_torch.tools import audit_multichip

    with pytest.raises(NotImplementedError, match="training over a mesh"):
        audit_multichip.main(["--case", "train", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


def test_daemon_over_mesh_serves_like_one_process(tmp_path):
    """``--mesh 2,1,1`` on two CPU ranks: requests answered as the unmeshed
    daemon answers them; a request that fails (a missing image) fails on
    both ranks, and the next one is served."""
    from PIL import Image

    cfg = tiny_test_config()
    cfg = cfg.replace(unet=cfg.unet.replace(flash_static_max=0.0))
    pretrained = synth.write_pretrained_dir(str(tmp_path / "sd"), np.random.default_rng(0))
    image = str(tmp_path / "cond.png")
    Image.fromarray((np.random.default_rng(0).random((32, 32, 3)) * 255).astype(np.uint8)).save(image)
    reqs = {"a_good": {"prompt": "a cat", "image": image, "seed": 3, "format": "npy"},
            "b_missing": {"prompt": "x", "image": str(tmp_path / "missing.png")},
            "c_good": {"prompt": "a dog", "image": image, "seed": 4, "format": "npy", "dispatch": "scan"}}
    argv = ["--pretrained_model_path", pretrained, "--num_frames", "2", "--height", "32", "--width", "32",
            "--num_inference_steps", "2", "--dtype", "float32", "--device", "cpu", "--no-int8_conv",
            "--max_requests", "5"]
    outs = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "2,1,1"])):
        req_dir, out_dir = str(tmp_path / name / "requests"), str(tmp_path / name / "output")
        os.makedirs(req_dir)
        for i, (rid, req) in enumerate(reqs.items()):
            path = os.path.join(req_dir, rid + ".json")
            with open(path, "w") as f:
                json.dump(req, f)
            t = time.time() + i
            os.utime(path, (t, t))
        assert serve.main(argv + ["--requests_dir", req_dir, "--output_dir", out_dir] + extra,
                          model_config=cfg) == 3
        outs[name] = out_dir
        assert sorted(os.listdir(req_dir)) == ["a_good.json.done", "b_missing.json.failed", "c_good.json.done"]
    for rid in ("a_good", "c_good"):
        one, meshed = (np.load(os.path.join(outs[k], rid + ".npy")).astype(int) for k in ("one", "mesh"))
        assert one.shape == meshed.shape == (1, 2, 32, 32, 3)
        assert np.abs(one - meshed).max() <= 1 and (one == meshed).mean() > 0.99
    with open(os.path.join(outs["mesh"], "b_missing.result.json")) as f:
        failed = json.load(f)
    assert not failed["ok"] and failed["error"].startswith("FileNotFoundError")
    assert failed["failed_ranks"] == [0, 1]


def _world():
    import torch.distributed as dist

    mesh = pmesh.create_mesh(MeshConfig(data=1, fsdp=1, tensor=1, seq=1), device="cpu")
    return dist.get_rank(), dist.get_world_size(), mesh.size(pmesh.AXES)


def test_torchrun_environment_joins_its_group(monkeypatch):
    """Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) ``run_meshed``
    joins that group and runs this process's rank instead of spawning; a
    mesh of another size is refused."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(key, value)
    try:
        assert launch.run_meshed(_world, MeshConfig(data=1, fsdp=1, tensor=1, seq=1), "cpu") == (0, 1, 1)
        with pytest.raises(ValueError, match="torchrun started 1"):
            launch.run_meshed(_world, MeshConfig(data=2, fsdp=1, tensor=1, seq=1), "cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
