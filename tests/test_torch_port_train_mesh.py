"""Training over a mesh, on the CPU: the port's ranks over gloo (one spawn of
4 ranks by ``parallel.launch.run_ranks`` for the module; their code in
``tests/torch_port_train_mesh_workers.py``, which imports no JAX) against
the JAX package and against the port on one process.

* each collective's gradient (all-gather, the all-to-all pair, the SUM
  all-reduce over ``seq``, the broadcast, both Megatron pairs) against
  single-process autograd of the unsplit computation, ``maxerr`` 1e-6; the
  MAX all-reduce refuses a gradient;
* ``train_state_shardings`` equal, leaf for leaf by Flax name, to the JAX
  ``train_state_shardings`` on the tiny train state (both ``fsdp_frozen``
  values, ``tensor`` 2, ``min_size`` lowered as ``tests/test_training.py``
  lowers it), and the placed state's blocks split on each rank;
* the train step at (4,1,1,1), (2,2,1,1), (2,1,1,2), (1,2,1,2) with
  ``fsdp_frozen='replicate'`` and (1,1,2,2) (the attention projections
  sliced over ``tensor``, trainables included): the global loss and the gathered trainable
  gradients against the JAX single-device ``make_train_step`` on the same
  global batch and draws (condition drops of both kinds), ``maxerr``
  1e-4; ``snr_gamma`` with ``first_frame_mode='exact'`` at (2,1,1,2); the
  motion modules at 100 tokens (split over ``seq``) and 25
  (not: K/V gathered);
* two steps (AdamW, EMA, ``gradient_accumulation_steps=2``) at (2,2,1,1)
  and at (2,1,1,2), and with EMA at (1,2,2,1), against the port's
  unmeshed two steps, and Adafactor on factored leaves at (1,2,2,1), at
  ``tests/test_torch_port_training.py``'s tolerance; a full-state save
  over each of those meshes restored by one process and the reverse, bit
  for bit;
* one step's collectives equal ``collectives_per_train_step``;
* the scaling bench (``--bench_model tiny``) over the 4 ranks: one record
  per shape that fits, with the JAX record's keys.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from i2v_adapter_tpu import config as jconfig
from i2v_adapter_tpu.models import AutoencoderKL as JVAE
from i2v_adapter_tpu.models import CLIPTextEncoder as JText
from i2v_adapter_tpu.models import CLIPVisionEncoder as JVision
from i2v_adapter_tpu.models import VideoUNet as JUNet
from i2v_adapter_tpu.parallel import mesh as jmesh
from i2v_adapter_tpu.training import state as jstate
from i2v_adapter_tpu.training.train_i2v import make_train_step as j_make_train_step
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.parallel import audit, launch
from i2v_adapter_tpu_torch.parallel import mesh as pmesh
from i2v_adapter_tpu_torch.utils.random_init import random_train_state
from tests import torch_port_train_mesh_workers as workers
from tests.test_torch_port_training import _draws
from tests.torch_port_common import maxerr, one_torch_thread, random_params  # noqa: F401

B, F, RES, L = 4, 4, 12, 16
EXACT = dict(flash_attention=False, fast_gelu=False, flash_static_max=0.0)
# spawned gloo ranks are bounded, so a hang fails the test instead of the run
RANKS_TIMEOUT_S = 300
BASE = dict(train_batch_size=B, num_frames=F, resolution=RES, gradient_accumulation_steps=1,
            mixed_precision="none", uncond_prob_t=0.3, uncond_prob_i=0.3, noise_offset=0.1,
            input_perturbation=0.05, gradient_checkpointing=True)
CASES = {"base": BASE, "snr_exact": dict(BASE, snr_gamma=5.0, first_frame_mode="exact")}
SMOOTH_ADAM = dict(learning_rate=1.0, adam_epsilon=1.0, adam_weight_decay=0.0)
TWO_STEPS = {
    "two_fsdp": {"mesh": (2, 2, 1, 1), "tc": dict(BASE, use_ema=True, ema_decay=0.9, gradient_accumulation_steps=2,
                                                  optimizer=SMOOTH_ADAM)},
    "two_seq": {"mesh": (2, 1, 1, 2), "tc": dict(CASES["snr_exact"], gradient_accumulation_steps=2,
                                                 optimizer=SMOOTH_ADAM)},
    "two_tensor": {"mesh": (1, 2, 2, 1), "tc": dict(BASE, use_ema=True, ema_decay=0.9, optimizer=SMOOTH_ADAM)},
}
ADAFACTOR = {"mesh": (1, 2, 2, 1), "min_size": 64,
             "tc": dict(BASE, train_batch_size=2, num_frames=2, update_motion_modules=True,
                        optimizer=dict(optimizer="adafactor", learning_rate=1e-2))}


def _rand(rng, shape):
    return rng.standard_normal(shape)


@pytest.fixture(scope="module")
def setup():
    mc = jconfig.tiny_test_config()
    mc = mc.replace(unet=mc.unet.replace(**EXACT))
    lat = RES // mc.vae.spatial_scale_factor
    ucfg = mc.unet
    size = mc.image_encoder.image_size
    params = {
        "unet": random_params(JUNet(ucfg), jnp.zeros((1, F, lat, lat, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, L, ucfg.cross_attention_dim)), jnp.zeros((1, ucfg.image_embed_dim)),
                              seed=1, enable_cross_frame_attn=True),
        "vae": random_params(JVAE(mc.vae), jnp.zeros((1, RES, RES, 3)), seed=2),
        "text_encoder": random_params(JText(mc.text_encoder), jnp.zeros((1, L), jnp.int32), seed=3),
        "image_encoder": random_params(JVision(mc.image_encoder), jnp.zeros((1, size, size, 3)), seed=4),
    }
    rng = np.random.default_rng(5)
    batch = {
        "pixel_values": rng.uniform(-1, 1, (B, F, RES, RES, 3)).astype(np.float32),
        "text_ids": rng.integers(0, 1000, (B, L)).astype(np.int64),
        "uncond_ids": np.zeros((B, L), np.int64),
        "clip_image": rng.standard_normal((B, size, size, 3)).astype(np.float32),
    }
    keys = {}
    for case, kw in CASES.items():
        jtc = jconfig.TrainConfig(**kw)
        for seed in range(200):  # a key whose dropout uniforms give both drops
            u = np.asarray(_draws(jax.random.PRNGKey(seed), B, F, lat, jtc)["drop_uniform"])
            if (u < 0.3).any() and ((u >= 0.3) & (u < 0.6)).any():
                keys[case] = seed
                break
    return {"mc": mc, "params": params, "batch": batch, "keys": keys, "lat": lat}


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """One spawn of 4 gloo ranks: every check's results (rank 0's)."""
    rng = np.random.default_rng(0)
    coll = {"x": _rand(rng, (8, 3, 5)), "w": _rand(rng, (4, 8, 3, 5)), "t": _rand(rng, (2, 4, 8, 6)),
            "wt": _rand(rng, (4, 2, 4, 8, 6)), "a": _rand(rng, (4, 5, 7))}
    tmp = tmp_path_factory.mktemp("train_mesh")
    params_path = str(tmp / "params.pkl")
    with open(params_path, "wb") as f:
        pickle.dump({**setup["params"], "config": setup["mc"].to_dict()}, f)
    cases = {}
    for case, kw in CASES.items():
        draws = _draws(jax.random.PRNGKey(setup["keys"][case]), B, F, setup["lat"], jconfig.TrainConfig(**kw))
        cases[case] = (jconfig.TrainConfig(**kw).to_dict(), {k: np.asarray(v) for k, v in draws.items()})
    bench_argv = ["--bench_scaling", "--bench_model", "tiny", "--bench_steps", "1", "--train_batch_size", "1",
                  "--bench_output", str(tmp / "bench.jsonl"), "--bench_mesh_shapes", "1,1,1;2,2,1;2,1,2;4,2,1",
                  "--device", "cpu"]
    out = launch.run_ranks(workers.all_checks, 4, (coll, params_path, cases, setup["batch"], TWO_STEPS, ADAFACTOR,
                                                   str(tmp / "ckpt"), bench_argv), device="cpu",
                           timeout=RANKS_TIMEOUT_S)
    return {"coll": coll, "out": out[0], "all": out, "bench_output": str(tmp / "bench.jsonl")}


# ---------------------------------------------------------------------------
# the collectives' adjoints
# ---------------------------------------------------------------------------


def _reference_grads(c: dict) -> dict:
    """Single-process autograd of the unsplit computations."""
    t = {k: torch.from_numpy(v).double() for k, v in c.items()}
    out = {}

    def grad(fn, x):
        x = x.clone().requires_grad_(True)
        fn(x).backward()
        return x.grad.numpy()

    out["all_gather"] = grad(lambda x: sum((t["w"][r] * x).sum() for r in range(4)), t["x"])
    w_frames = torch.stack([t["wt"][r][:, r] for r in range(4)], 1)
    out["all_to_all_pair"] = grad(lambda x: (w_frames * torch.tanh(x)).sum(), t["t"])
    w_tokens = torch.cat([t["wt"][r][:, :, 2 * r:2 * r + 2] for r in range(4)], 2)
    out["all_to_all"] = grad(lambda x: (w_tokens * x).sum(), t["t"])
    out["all_reduce"] = grad(lambda x: sum((t["w"][r][0] * x.sum(0)).sum() for r in range(4)), t["x"])
    out["broadcast"] = grad(lambda x: sum((t["w"][r][:2] * x[:2]).sum() for r in range(4)), t["x"])
    out["reduce_from_parallel"] = grad(
        lambda x: (t["w"][0][:2] * sum(x[2 * r:2 * r + 2] for r in range(4))).sum(), t["x"])
    out["copy_to_parallel"] = grad(lambda x: sum(
        (t["w"][r][:2, :, :1].expand(2, 3, 7) * (x @ t["a"][r])).sum() for r in range(4)), t["x"][:2])
    return out


@pytest.mark.parametrize("name", ["all_gather", "all_to_all", "all_to_all_pair", "all_reduce", "broadcast",
                                  "reduce_from_parallel", "copy_to_parallel"])
def test_collective_gradient_matches_autograd(runs, name):
    want = _reference_grads(runs["coll"])[name]
    got = runs["out"]["collectives"][name]
    assert got.shape == want.shape
    assert maxerr(got, want) <= 1e-6
    for rank in runs["all"][1:]:  # every rank gathered the same
        np.testing.assert_array_equal(rank["collectives"][name], got)


def test_max_all_reduce_is_forward_only(runs):
    out = runs["out"]["collectives"]
    np.testing.assert_array_equal(out["max_forward"], runs["coll"]["x"][:4].max(0))
    assert out["max_backward_raised"]


# ---------------------------------------------------------------------------
# the state's placement
# ---------------------------------------------------------------------------


def _port_name(path) -> str:
    keys = [str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))) for k in path]
    keys = [k for k in keys if k != "params"]
    if keys[0] == "opt_state":
        for i, k in enumerate(keys):
            if k in ("mu", "nu", "v_row", "v_col", "v", "acc_grads"):
                return "/".join(["opt_state", "acc" if k == "acc_grads" else k] + keys[i + 1:])
        return ""
    return "/".join(keys)


@pytest.mark.parametrize("sizes,frozen,min_size,optimizer", [
    ((4, 2, 1, 1), "shard", 1024, "adamw"), ((4, 2, 1, 1), "replicate", 256, "adamw"),
    ((2, 2, 2, 1), "shard", 1024, "adamw"), ((4, 2, 1, 1), "shard", 64, "adafactor")])
def test_train_state_shardings_match_jax(setup, sizes, frozen, min_size, optimizer):
    """Every leaf's spec by its Flax name, the JAX rule's answer, on the
    tiny train state (EMA and MultiSteps on, so every field is there)."""
    kw = dict(train_batch_size=2, num_frames=F, resolution=RES, mixed_precision="none", use_ema=True,
              gradient_accumulation_steps=2, fsdp_frozen=frozen, optimizer=dict(optimizer=optimizer))
    p = setup["params"]
    jst, _ = jstate.create_train_state(p["unet"], jconfig.TrainConfig.from_dict(kw), 10, p["vae"],
                                       p["text_encoder"], p["image_encoder"])
    jm = jmesh.create_mesh(jconfig.MeshConfig(*sizes))
    want = {}
    shardings = jmesh.train_state_shardings(jst, jm, min_size=min_size, frozen_replicated=frozen == "replicate")
    for (path, sharding), leaf in zip(jax.tree_util.tree_leaves_with_path(shardings), jax.tree.leaves(jst)):
        name = _port_name(path)
        # optax's Adafactor keeps (1,)-shaped placeholders for the statistics
        # a leaf does not use; the port keeps none
        placeholder = name.startswith("opt_state/v") and tuple(leaf.shape) == (1,)
        if name and name != "step" and not placeholder:
            want[name] = tuple(sharding.spec)
    mc = pconfig.I2VModelConfig.from_dict(setup["mc"].to_dict())
    state = random_train_state(mc, pconfig.TrainConfig.from_dict(kw), "cpu")
    got = pmesh.train_state_shardings(state, dict(zip(pmesh.AXES, sizes)), min_size, frozen == "replicate")
    assert set(got) == set(want)
    assert got == want
    assert any("fsdp" in s for s in got.values())
    # shard_params_fsdp over the trainable tree, as the JAX one answers
    jspecs = jmesh.shard_params_fsdp(jst.trainable, jm, min_size)
    shapes = {"trainable/" + "/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_leaves_with_path(jst.trainable)}
    fsdp_specs = pmesh.shard_params_fsdp(shapes, dict(zip(pmesh.AXES, sizes)), min_size)
    assert fsdp_specs == {name: tuple(s.spec) for name, s in zip(
        shapes, jax.tree.leaves(jspecs, is_leaf=lambda x: hasattr(x, "spec")))}
    assert any("tensor" in s for s in got.values()) == (sizes[2] > 1)


def test_placed_state_is_split_on_each_rank(runs):
    """Each rank holds its block of every sharded leaf (checked against the
    gathered whole inside the ranks)."""
    steps = runs["out"]["steps"]
    assert steps["base/2,2,1,1"]["split"] > 0 and steps["base/1,2,1,2/replicate"]["split"] > 0
    assert steps["base/4,1,1,1"]["split"] == 0
    assert runs["out"]["two_fsdp"]["split"] > 0 and runs["out"]["adafactor"]["split"] > 0


# ---------------------------------------------------------------------------
# the step against JAX
# ---------------------------------------------------------------------------


def _grads_tx():
    """An optax transformation whose state after an update is the update's
    gradients (and whose update is zero): the JAX step's gradients."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX single-device step's loss and gradients per case."""
    p, out = setup["params"], {}
    for case, kw in CASES.items():
        jtc = jconfig.TrainConfig(**kw)
        jst, _ = jstate.create_train_state(p["unet"], jtc, 10, p["vae"], p["text_encoder"], p["image_encoder"])
        tx = _grads_tx()
        step = j_make_train_step(setup["mc"], jtc, tx, donate=False)
        batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
        new, metrics = step(jst.replace(opt_state=tx.init(jst.trainable)), batch,
                            jax.random.PRNGKey(setup["keys"][case]))
        grads = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
                 for path, g in jax.tree_util.tree_leaves_with_path(new.opt_state)}
        out[case] = {"loss": float(metrics["loss"]), "grads": grads}
    return out


STEP_CASES = [f"base/{m}" for m in workers.STEP_MESHES] + [f"snr_exact/{workers.SNR_MESH}"]


@pytest.mark.parametrize("key", STEP_CASES)
def test_meshed_step_matches_jax_single_device(runs, jax_steps, key):
    case = key.split("/", 1)[0]
    got, want = runs["out"]["steps"][key], jax_steps[case]
    assert maxerr(got["loss"], want["loss"]) <= 1e-4
    assert set(got["grads"]) == set(want["grads"])
    top = max(float(np.abs(g).max()) for g in want["grads"].values())
    assert top > 0
    for name, g in want["grads"].items():
        assert got["grads"][name].shape == g.shape, name
        assert maxerr(got["grads"][name], g) <= 1e-4, name


@pytest.mark.parametrize("key", STEP_CASES)
def test_train_step_collectives_equal_formula(runs, setup, key):
    """One recorded ``loss_and_grads`` (the forward, its recompute, the
    backward, ZeRO's gathers and reduce-scatters, the gradients' and the
    loss's sums) against ``collectives_per_train_step`` less the norm's
    all-reduces (made by the step after it, not here)."""
    got = runs["out"]["steps"][key]
    case, name = key.split("/", 1)
    sizes, _ = workers.STEP_MESHES[name]
    tc = pconfig.TrainConfig(**CASES[case])
    ucfg = pconfig.VideoUNetConfig.from_dict(setup["mc"].unet.to_dict())
    want = audit.collectives_per_train_step(ucfg, dict(zip(pmesh.AXES, sizes)), tc, B, F, setup["lat"],
                                            got["zero"])
    # less the norm's all-reduces, made by the step after it, not here
    want["all-reduce"] -= (int(got["zero"]["fsdp_trainables"] > 0 and sizes[1] > 1)
                           + int(got["zero"]["tensor_trainables"] > 0 and sizes[2] > 1))
    want = {k: v for k, v in want.items() if v}
    assert got["counts"] == want
    if sizes[3] > 1:
        assert {"all-to-all", "all-gather", "reduce-scatter", "reduce", "collective-broadcast"} <= set(want)


# ---------------------------------------------------------------------------
# two steps, Adafactor, checkpoints
# ---------------------------------------------------------------------------


def _assert_states_close(close: dict):
    """The updates of the trainables (and the EMA) to 1e-3 of their largest
    |update| (``tests/test_torch_port_training.py``'s tolerance), the
    optimizer's statistics to 1e-3 of their largest value, the rest equal
    (``workers.compare_states``' numbers)."""
    assert close.pop("names_equal")
    for name, (shape_ok, err, scale) in close.items():
        assert shape_ok, name
        if name.split("/")[0] in ("trainable", "ema"):
            assert err <= 1e-3 * scale + 1e-7, name
        elif name.startswith("opt_state/"):
            assert err <= 1e-3 * scale + 1e-12, name
        else:
            assert err == 0.0, name


@pytest.mark.parametrize("name", sorted(TWO_STEPS))
def test_two_meshed_steps_match_unmeshed(runs, name):
    """AdamW with EMA and 2-step accumulation (one inner update in two
    calls) over (2,2,1,1) with ZeRO blocks, and over (2,1,1,2) with
    ``snr_gamma`` and ``first_frame_mode='exact'``; AdamW with EMA over
    (1,2,2,1), the projections split over ``tensor`` and the rest over
    ``fsdp`` (two inner updates)."""
    r = runs["out"][name]
    assert r["split"] > 0 or TWO_STEPS[name]["mesh"][1] == 1
    assert all(np.isfinite(r["losses"]))
    _assert_states_close(dict(r["close"]))


def test_adafactor_over_fsdp_matches_unmeshed(runs):
    """Two Adafactor steps at (1,2,2,1) with factored leaves (128-wide
    blocks, the motion modules trained, ``min_size`` 64 so the statistics
    split too), the projections' over ``tensor`` and the rest over
    ``fsdp``, equal the unmeshed ones."""
    r = runs["out"]["adafactor"]
    assert r["factored"] > 0 and r["split"] > 0
    _assert_states_close(dict(r["close"]))


@pytest.mark.parametrize("name", sorted(TWO_STEPS))
def test_full_state_saves_cross_meshes(runs, name):
    """The meshed run's save restored by one process equals the meshed
    state, and the one-process save restored over the mesh equals the
    one-process state, bit for bit."""
    r = runs["out"][name]
    assert r["restored_by_one_unequal"] == [] and r["restored_over_mesh_unequal"] == []
    accumulation = TWO_STEPS[name]["tc"]["gradient_accumulation_steps"]
    assert r["counters"] == (2, 2 // accumulation, 0)


# ---------------------------------------------------------------------------
# the bench
# ---------------------------------------------------------------------------


def test_bench_scaling_cpu_sim(runs):
    """The scaling bench's rank function over the 4 ranks (``main
    --bench_scaling`` spawns them; tests/test_torch_port_driver.py runs it
    end to end): one record per shape that fits, the JAX record's keys,
    the weak-scaling batch, each record appended to ``--bench_output``."""
    records = runs["out"]["bench"]
    with open(runs["bench_output"]) as f:
        written = [json.loads(line) for line in f]
    assert written == records
    assert [tuple(r["mesh"].values()) for r in records] == [(1, 1, 1), (2, 2, 1), (2, 1, 2)]
    assert [r["global_batch"] for r in records] == [1, 4, 2] and [r["devices"] for r in records] == [1, 4, 4]
    assert all(set(r) == {"mesh", "devices", "model", "resolution", "num_frames", "global_batch", "step_time_s",
                          "clips_per_s", "clips_per_s_per_device", "compile_s", "loss"} for r in records)
    assert all(np.isfinite(r["loss"]) and r["step_time_s"] > 0 for r in records)


@pytest.mark.parametrize("mesh", ["2,1,1,2", "1,1,2,2", "2,2,1,1"])
def test_block_ranks_train_on_the_same_clips(runs, mesh):
    """The driver's ``block_batches`` over a loader of 4 threads whose
    items draw from one shared generator (as the WebVid items do): every
    rank of a ``(data, fsdp)`` block gets the same batches, the same draws
    for each clip, and its block's rows of the loader's order."""
    seen = runs["out"]["block_batches"][mesh]
    order = runs["out"]["block_batches"]["order"]
    blocks = {}
    for block, batches in seen:
        blocks.setdefault(block, []).append(batches)
    ways = len(blocks)
    assert ways == int(mesh.split(",")[0]) * int(mesh.split(",")[1])
    for block, got in blocks.items():
        assert len(got) == 4 // ways and all(g == got[0] for g in got), (block, got)
        rows = [order[i + block * (4 // ways):i + (block + 1) * (4 // ways)] for i in range(0, 16, 4)]
        assert [[item[0] for item in b] for b in got[0]] == rows
