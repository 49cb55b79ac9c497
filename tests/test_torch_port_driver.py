"""PyTorch port vs the JAX package: the training driver and what it writes.

* ``parse_args``: the JAX driver's flags, defaults and errors (plus
  ``--device``); the multi-GPU options on 2 gloo ranks: the one-process
  run's losses, its checkpoints, the scaling bench's records;
* Adafactor (factored and unfactored leaves, clipping, MultiSteps) against
  the JAX ``make_optimizer`` over several updates, 1e-6; a JAX Adafactor /
  MultiSteps state carried into the port by ``load_train_state``;
* adapter checkpoints and pipeline exports written by one package and read
  by the other, bit for bit;
* ``TrainCheckpointer``: a round trip bit for bit, retention, async saves,
  and 2 steps + save + restore + 1 step equal to 3 steps bit for bit;
* the port's ``train()`` against the JAX ``train()`` on the fixture of
  ``tests/test_driver.py`` (fp32, one loader thread, 2 steps, the port fed
  the JAX driver's random keys): losses to 1e-4, the epoch checkpoint's
  update to 1e-3 of its largest change;
* the train state's dtypes against the JAX driver's for an fp32 and an fp16
  directory under ``none`` and ``bfloat16`` (a recorded deviation: the
  port's masters and moments are fp32);
* epoch resume, the EMA export with ``non_ema/``, ``--text_padding
  longest``, t2i mode, a validation sample equal to a pipeline built from
  the export (its int8 convs, site for site, as ``chip_smoke`` derives
  them), and an overfit run on one clip;
* Adafactor's state refused without the Flax layouts.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from i2v_adapter_tpu import config as jconfig
from i2v_adapter_tpu.data import native as jnative
from i2v_adapter_tpu.pipelines.i2v_pipeline import I2VAdapterPipeline as JPipeline
from i2v_adapter_tpu.training import checkpoint as jckpt
from i2v_adapter_tpu.training import driver as jdriver
from i2v_adapter_tpu.training import state as jstate
from i2v_adapter_tpu.utils import convert as jconvert
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.data import native as pnative
from i2v_adapter_tpu_torch.models import layers as player
from i2v_adapter_tpu_torch.parallel import mesh as pmesh
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
from i2v_adapter_tpu_torch.training import checkpoint as pckpt
from i2v_adapter_tpu_torch.training import driver as pdriver
from i2v_adapter_tpu_torch.training import make_optimizer, make_train_step
from i2v_adapter_tpu_torch.utils import convert as pconvert
from i2v_adapter_tpu_torch.utils.random_init import random_train_batch, random_train_state
from tests.synth import write_pretrained_dir
from tests.test_torch_port_training import _draws
from tests.torch_port_common import one_torch_thread  # noqa: F401
from tests.torch_port_synth import write_pretrained_dir as write_port_dir

cv2 = pytest.importorskip("cv2")

RES, FRAMES, BATCH = 32, 4, 2


def _exact(cfg):
    """The plain attention math on both sides (tests/synth.py's weights are
    unscaled: the port's static softmax offset would leave its range)."""
    return cfg.replace(unet=cfg.unet.replace(flash_attention=False, flash_static_max=0.0))


JCFG, PCFG = _exact(jconfig.tiny_test_config()), _exact(pconfig.tiny_test_config())


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """tests/test_driver.py's fixture: a tiny pretrained directory and four
    10-frame 48 px clips; plus an eval CSV."""
    root = tmp_path_factory.mktemp("port_driver")
    rng = np.random.default_rng(0)
    pretrained = write_pretrained_dir(str(root / "pretrained"), rng)
    video_dir = root / "videos" / "p0"
    video_dir.mkdir(parents=True)
    rows = []
    for vid in ("v0", "v1", "v2", "v3"):
        w = cv2.VideoWriter(str(video_dir / f"{vid}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (48, 48))
        if not w.isOpened():
            pytest.skip("no mp4 writer")
        for _ in range(10):
            w.write((rng.random((48, 48, 3)) * 255).astype(np.uint8))
        w.release()
        rows.append({"videoid": vid, "name": f"a {vid}", "page_dir": "p0"})
    csv_path = str(root / "train.csv")
    with open(csv_path, "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=["videoid", "name", "page_dir"])
        wtr.writeheader()
        wtr.writerows(rows)
    from PIL import Image

    Image.fromarray((rng.random((RES, RES, 3)) * 255).astype(np.uint8)).save(str(root / "cond.png"))
    eval_csv = str(root / "eval.csv")
    with open(eval_csv, "w") as f:
        f.write(f"prompt,image_path\na v0,{root / 'cond.png'}\n")
    return {"root": str(root), "pretrained": pretrained, "csv": csv_path, "videos": str(root / "videos"),
            "eval_csv": eval_csv}


def _argv(env, **over):
    base = dict(task_name="t", pretrained_model_path=env["pretrained"], csv_path=env["csv"],
                video_folder=env["videos"], output_dir=os.path.join(env["root"], "port"),
                resolution=RES, n_frames=FRAMES, train_batch_size=BATCH, gradient_accumulation_steps=1,
                num_train_epochs=1, checkpoint_epoch=1, num_workers=1, mixed_precision="none",
                max_train_steps=2, seed=0, report_to="none")
    base.update(over)
    argv = []
    for k, v in base.items():
        if isinstance(v, bool):
            if v:
                argv.append(f"--{k}")
        elif v is not None:
            argv.extend([f"--{k}", str(v)])
    return argv


def _train(env, device="cpu", **over):
    return pdriver.train(pdriver.parse_args(_argv(env, device=device, **over)), model_config=PCFG)


def _load(path):
    from safetensors.numpy import load_file

    return load_file(path)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["--train_mode", "t2i", "--optimizer", "adafactor", "--use_ema", "--scale_lr", "--snr_gamma", "5",
     "--text_padding", "longest", "--async_checkpoint", "--max_train_steps", "7", "--report_to", "all",
     "--resume_from_checkpoint", "latest", "--checkpoints_total_limit", "3", "--fsdp_frozen", "replicate"],
], ids=["defaults", "flags"])
def test_parse_args_matches_jax(env, argv):
    full = _argv(env)[:8] + argv
    want = vars(jdriver.parse_args(full))
    got = vars(pdriver.parse_args(full))
    assert got.pop("device") is None
    assert got == want
    assert pdriver.args_to_train_config(pdriver.parse_args(full)).to_dict() == \
        jdriver.args_to_train_config(jdriver.parse_args(full)).to_dict()


def test_parse_args_errors_match_jax(capsys):
    for mod in (jdriver, pdriver):
        with pytest.raises(SystemExit):
            mod.parse_args(["--task_name", "t"])
    jerr, perr = capsys.readouterr().err.split("error: ")[1:]
    assert perr.splitlines()[0] == jerr.splitlines()[0]
    assert "--pretrained_model_path, --csv_path, --video_folder" in perr
    assert pdriver.parse_args(["--bench_scaling"]).bench_scaling  # no paths needed, as in JAX


@pytest.fixture(scope="module")
def mesh_env(env, tmp_path_factory):
    """``env`` with the port's own tiny pretrained directory, whose weights
    are drawn at trained scales: its losses are of order 1, where 1e-5 is
    some 80 fp32 ulps.  ``env``'s unscaled weights give losses near 200,
    where 1e-5 is under one ulp and the 2 ranks' gradient sum, added in
    another order than the one-process batch's, may round apart."""
    root = tmp_path_factory.mktemp("port_driver_mesh")
    write_port_dir(str(root / "pretrained"), PCFG, seed=3)
    return dict(env, root=str(root), pretrained=str(root / "pretrained"))


@pytest.fixture(scope="module")
def unmeshed_run(mesh_env):
    """The driver on one process: the losses the meshed runs must equal."""
    return _train(mesh_env, task_name="one_rank", checkpointing_steps=2)


@pytest.mark.parametrize("flags", [["--data_fsdp", "2"], ["--seq_parallel", "2"], ["--bench_scaling"]])
def test_multi_gpu_options_refused(mesh_env, unmeshed_run, flags, tmp_path):
    """The JAX driver's multi-device options, once refused, run on 2 gloo
    ranks (``main(..., ranks=2)``): ``--data_fsdp 2`` (the batch's 2 clips
    over fsdp, each rank decoding its clip) and ``--seq_parallel 2`` (the 4
    frames over seq) give the one-process run's per-step losses within
    1e-5 and write its full-state and epoch checkpoints; ``--bench_scaling``
    writes one record per shape that fits 2 ranks, with the JAX record's
    keys.  A batch that does not split is refused before the first step."""
    if flags == ["--bench_scaling"]:
        out = str(tmp_path / "bench.jsonl")
        records = pdriver.main(["--bench_scaling", "--bench_model", "tiny", "--bench_steps", "1",
                                "--bench_mesh_shapes", "1,1,1;2,1,1;1,2,1;1,1,2;2,2,1", "--bench_output", out,
                                "--train_batch_size", "1", "--device", "cpu"], ranks=2)
        with open(out) as f:
            written = [json.loads(line) for line in f]
        assert written == records and [r["mesh"] for r in records] == [
            {"data": 1, "fsdp": 1, "seq": 1}, {"data": 2, "fsdp": 1, "seq": 1}, {"data": 1, "fsdp": 2, "seq": 1},
            {"data": 1, "fsdp": 1, "seq": 2}]
        assert set(records[0]) == {"mesh", "devices", "model", "resolution", "num_frames", "global_batch",
                                   "step_time_s", "clips_per_s", "clips_per_s_per_device", "compile_s", "loss"}
        assert [r["global_batch"] for r in records] == [1, 2, 2, 1] and all(np.isfinite(r["loss"]) for r in records)
        return
    task = "mesh_" + flags[0].strip("-")
    result = pdriver.main(_argv(mesh_env, device="cpu", task_name=task, checkpointing_steps=2) + flags,
                          model_config=PCFG, ranks=2)
    np.testing.assert_allclose(result["losses"], unmeshed_run["losses"], rtol=0, atol=1e-5)
    task_dir = os.path.join(mesh_env["root"], "port", task)
    assert [s["step"] for s in result["state_saves"]] == [2]
    one = _load(os.path.join(mesh_env["root"], "port", "one_rank", "state", "step_2.safetensors"))
    meshed = _load(os.path.join(task_dir, "state", "step_2.safetensors"))
    assert set(meshed) == set(one) and all(meshed[k].shape == one[k].shape for k in one)
    assert os.path.exists(os.path.join(task_dir, "epoch_1", "i2v_adapter", "diffusion_pytorch_model.safetensors"))
    assert os.path.exists(os.path.join(task_dir, "pipeline", "unet", "flax_model.safetensors"))
    # the refusal setup() makes before anything is built, on this mesh's shape
    odd = {"train_batch_size": 1} if flags[0] == "--data_fsdp" else {"n_frames": 3}
    tc = pdriver.args_to_train_config(pdriver.parse_args(_argv(mesh_env, device="cpu", **odd) + flags))
    mesh = pmesh.Mesh(dict(zip(pmesh.AXES, pmesh.mesh_shape(tc.mesh, 2))), 0, torch.device("cpu"), {})
    with pytest.raises(ValueError, match="do not split over the mesh"):
        pdriver.check_mesh_divides(tc, mesh)


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

# Flax-layout leaves and the permutation the port's layout is of them:
# factored (two axes >= 128, one of them square), unfactored, a 4-D conv
_LEAVES = {"lin": ((256, 128), (1, 0)), "square": ((128, 128), (1, 0)), "conv": ((3, 3, 128, 160), (3, 2, 0, 1)),
           "small": ((64, 32), (1, 0)), "bias": ((130,), None)}


def _torch_layout(x, perm):
    return x if perm is None else np.ascontiguousarray(x.transpose(perm))


@pytest.mark.parametrize("accum", [1, 2])
def test_adafactor_matches_optax(accum):
    """Six calls of clip + Adafactor (+ MultiSteps(2)) with a warmup, small
    and large gradients (clipping off and on): every parameter after every
    call, and the factored / full statistics at the end, 1e-6."""
    kw = dict(gradient_accumulation_steps=accum, optimizer=dict(
        optimizer="adafactor", learning_rate=1e-2, lr_scheduler="constant_with_warmup", lr_warmup_steps=2,
        max_grad_norm=0.5))
    tx = jstate.make_optimizer(jconfig.TrainConfig.from_dict(kw), 6)
    opt = make_optimizer(pconfig.TrainConfig.from_dict(kw), 6)
    rng = np.random.default_rng(0)
    params = {n: rng.standard_normal(shape).astype(np.float32) for n, (shape, _) in _LEAVES.items()}
    # the port's layout (torch) is a permutation of the Flax one; its
    # layouts map back: torch.permute(layouts[n]) is the Flax array
    to_torch = {n: (None if perm is None else tuple(np.argsort(perm))) for n, (_, perm) in _LEAVES.items()}
    layouts = {n: perm for n, (_, perm) in _LEAVES.items() if perm is not None}
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    tp = {n: torch.from_numpy(_torch_layout(v, to_torch[n])) for n, v in params.items()}
    for n in tp:
        assert np.array_equal(tp[n].permute(layouts[n]).numpy() if n in layouts else tp[n].numpy(), params[n])
    jst, tst = tx.init(jp), opt.init(tp, layouts)
    update = jax.jit(tx.update)
    for call in range(6):
        scale = 1e-4 if call % 3 == 0 else 0.7
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in params.items()}
        upd, jst = update({k: jax.numpy.asarray(v) for k, v in grads.items()}, jst, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        tupd = opt.update({n: torch.from_numpy(_torch_layout(g, to_torch[n])) for n, g in grads.items()}, tst, tp)
        tp = {n: tp[n] + tupd[n] for n in tp}
        for n in params:
            got = tp[n].permute(layouts[n]).numpy() if n in layouts else tp[n].numpy()
            np.testing.assert_allclose(got, np.asarray(jp[n]), rtol=1e-6, atol=1e-7, err_msg=f"call {call} {n}")
    factored = next(s for s in pconvert._optax_states(jst) if type(s).__name__ == "FactoredState")
    assert set(tst.v_row) == set(tst.v_col) == {"lin", "square", "conv"} and set(tst.v) == {"small", "bias"}
    for key in ("v_row", "v_col", "v"):
        for n, t in getattr(tst, key).items():
            np.testing.assert_allclose(t.numpy(), np.asarray(getattr(factored, key)[n]), rtol=1e-6, atol=1e-12)
    assert tst.count == int(factored.count) == 6 // accum


def test_adafactor_warns_on_adam_flags():
    tc = pconfig.TrainConfig(optimizer=pconfig.OptimizerConfig(optimizer="adafactor", adam_beta1=0.8))
    with pytest.warns(UserWarning, match="adam_beta1"):
        make_optimizer(tc, 10)


def test_adafactor_needs_flax_layouts():
    """Adafactor factors in the Flax layout: its state is not built without
    the layouts (AdamW's moments keep each parameter's own layout)."""
    tc = pconfig.TrainConfig(optimizer=pconfig.OptimizerConfig(optimizer="adafactor"))
    params = {"w": torch.zeros(256, 128)}
    with pytest.raises(ValueError, match="layouts"):
        make_optimizer(tc, 10).init(params)
    assert set(make_optimizer(tc, 10).init(params, {}).v_row) == {"w"}
    assert set(make_optimizer(pconfig.TrainConfig(), 10).init(params).mu) == {"w"}


@pytest.mark.parametrize("optimizer,accum", [("adafactor", 2), ("adamw", 2)])
def test_load_train_state_carries_optimizer_state(jax_pipe, optimizer, accum):
    """A JAX train state (the adapters training) after three optimizer
    calls, carried into the port by ``load_train_state``: its step,
    counters, accumulator and moments or statistics; one more call on both
    sides gives the same parameters, 1e-6."""
    from i2v_adapter_tpu_torch.models import VideoUNet
    from i2v_adapter_tpu_torch.training import create_train_state

    ucfg = JCFG.unet
    jnp = jax.numpy
    unet_params = jax_pipe.params["unet"]
    kw = dict(gradient_accumulation_steps=accum, optimizer=dict(
        optimizer=optimizer, learning_rate=1e-2, max_grad_norm=1.0))
    jtc = jconfig.TrainConfig.from_dict(kw)
    jst, tx = jstate.create_train_state(unet_params, jtc, 10)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(3)

    def grads_like(tree):
        return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1), tree)

    for _ in range(3):
        upd, opt_state = update(grads_like(jst.trainable), jst.opt_state, jst.trainable)
        jst = jst.replace(step=jst.step + 1, opt_state=opt_state,
                          trainable=jax.tree.map(lambda p, u: p + u, jst.trainable, upd))
    pstate = create_train_state(VideoUNet(pconfig.VideoUNetConfig.from_dict(ucfg.to_dict()), device="cpu"),
                                pconfig.TrainConfig.from_dict(kw), 10)
    pconvert.load_train_state(pstate, jst)
    assert pstate.step == 3 and pstate.opt_state.mini_step == 3 % accum
    assert pstate.opt_state.count == 3 // accum
    g = grads_like(jst.trainable)
    upd, _ = update(g, jst.opt_state, jst.trainable)
    want = pconvert.flatten_tree(jax.tree.map(lambda p, u: np.asarray(p + u), jst.trainable, upd), sep="/")
    params = pstate.trainable_params()
    tg = {n: torch.from_numpy(v) for n, v in _torch_named(pstate.unet, g).items()}
    tupd = pstate.optimizer.update(tg, pstate.opt_state, params)
    got = pconvert.flatten_tree(pconvert.to_flax_tree(pstate.unet, {n: params[n].detach() + tupd[n]
                                                                    for n in params}), sep="/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def _torch_named(module, flax_tree):
    """A Flax-layout tree as arrays keyed by ``module``'s parameter names,
    in the PyTorch layout."""
    flat = pconvert.flatten_tree(flax_tree, sep="/")
    modules = dict(module.named_modules())
    out = {}
    for name, _ in module.named_parameters():
        path, perm = pconvert.flax_leaf(modules, name)
        key = "/".join(path)
        if key in flat:
            v = np.asarray(flat[key], np.float32)
            out[name] = np.array(v.transpose(np.argsort(perm)) if perm is not None else v)
    return out


# ---------------------------------------------------------------------------
# the files one package writes and the other reads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pipe(env):
    return JPipeline.from_pretrained(env["pretrained"], JCFG, jconfig.PipelineConfig(dtype="float32"))


def _perturbed(tree, seed):
    """The UNet tree with every adapter and motion leaf moved."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    rng = np.random.default_rng(seed)

    flat = flatten_dict(tree["params"], sep="/")
    out = {k: (np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32) * 0.1
               if "i2v_adapter" in k or "motion_modules" in k else np.asarray(v)) for k, v in flat.items()}
    return {"params": unflatten_dict(out, sep="/")}


def test_adapter_checkpoints_interchange(env, jax_pipe, tmp_path):
    """The same tree written by each package (adapters and motion modules):
    the same tensors bit for bit and the same config; each package's loader
    reads the other's files into the same tree, the port's also into a UNet
    module."""
    from flax.traverse_util import flatten_dict

    tree = _perturbed(jax_pipe.params["unet"], 1)
    jckpt.save_adapter_checkpoint(tree, JCFG.unet, str(tmp_path / "jax"), save_motion=True)
    pckpt.save_adapter_checkpoint(tree, PCFG.unet, str(tmp_path / "port"), save_motion=True)
    for sub in ("i2v_adapter", "motion_modules"):
        want = _load(str(tmp_path / "jax" / sub / "diffusion_pytorch_model.safetensors"))
        got = _load(str(tmp_path / "port" / sub / "diffusion_pytorch_model.safetensors"))
        assert set(got) == set(want) and want
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
    with open(tmp_path / "jax" / "i2v_adapter" / "config.json") as f, \
            open(tmp_path / "port" / "i2v_adapter" / "config.json") as g:
        assert json.load(g) == json.load(f)
    base = jax_pipe.params["unet"]
    want = flatten_dict(jckpt.load_adapter_checkpoint(base, JCFG.unet, str(tmp_path / "port")), sep="/")
    got = pconvert.flatten_tree(pckpt.load_adapter_checkpoint(base, PCFG.unet, str(tmp_path / "jax")), sep="/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    moved = {k for k in want if "i2v_adapter" in k or "motion_modules" in k}
    pipe = I2VAdapterPipeline.from_pretrained(env["pretrained"], PCFG, pconfig.PipelineConfig(dtype="float32",
                                              int8_conv=False), device="cpu")
    pckpt.load_adapter_checkpoint(pipe.unet, PCFG.unet, str(tmp_path / "jax"))
    module = pconvert.flatten_tree(pconvert.to_flax_tree(pipe.unet), sep="/")
    for k in want:
        np.testing.assert_array_equal(module[k.removeprefix("params/")], np.asarray(want[k]), err_msg=k)
    assert moved


def test_pipeline_export_interchange(env, jax_pipe, tmp_path):
    """``export_pipeline`` / ``load_pipeline_params`` both ways: the JAX
    export read by the port, the port's export of its modules read by the
    JAX loader, leaf for leaf, with the same config files."""
    from flax.traverse_util import flatten_dict

    jtc = jconfig.TrainConfig(train_batch_size=2)
    params = {k: jax_pipe.params[k] for k in ("unet", "vae", "text_encoder", "image_encoder")}
    jckpt.export_pipeline(params, JCFG, str(tmp_path / "jax"), jtc)
    got = pckpt.load_pipeline_params(str(tmp_path / "jax"))
    assert set(got) == set(params)
    for name in params:
        want = flatten_dict(params[name], sep="/")
        flat = pconvert.flatten_tree(got[name], sep="/")
        assert set(flat) == set(want)
        for k in want:
            np.testing.assert_array_equal(flat[k], np.asarray(want[k]))
    pipe = I2VAdapterPipeline(pconfig.I2VModelConfig.from_dict(JCFG.to_dict()), got, None,
                              pconfig.PipelineConfig(dtype="float32", int8_conv=False), device="cpu")
    modules = {"unet": pipe.unet, "vae": pipe.vae, "text_encoder": pipe.text_encoder,
               "image_encoder": pipe.image_encoder}
    pckpt.export_pipeline(modules, PCFG, str(tmp_path / "port"), pconfig.TrainConfig(train_batch_size=2))
    back = jckpt.load_pipeline_params(str(tmp_path / "port"))
    for name, module in modules.items():
        want = pconvert.flatten_tree(pconvert.to_flax_tree(module), sep="/")
        flat = flatten_dict(back[name]["params"], sep="/")
        assert set(flat) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(flat[k]), want[k])
    for name in ("model_config.json", "train_config.json"):
        with open(tmp_path / "jax" / name) as f, open(tmp_path / "port" / name) as g:
            assert json.load(g) == json.load(f)


# ---------------------------------------------------------------------------
# full train states
# ---------------------------------------------------------------------------

TC_KW = dict(train_batch_size=2, num_frames=2, resolution=32, mixed_precision="none", use_ema=True,
             ema_decay=0.9, freeze_dtype="bfloat16")


def _snapshot(state):
    return {k: v.clone() for k, v in pckpt.train_state_tensors(state).items()}


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("optimizer,accum", [("adamw", 1), ("adafactor", 2)])
def test_train_checkpointer_resume_equals_uninterrupted(tmp_path, optimizer, accum):
    """3 steps in one go, and 2 steps + save + restore into a fresh state +
    1 step: every tensor of the two states (parameters, moments or factors,
    accumulator, EMA, frozen towers) and every counter equal bit for bit."""
    tc = pconfig.TrainConfig.from_dict(dict(TC_KW, gradient_accumulation_steps=accum,
                                            optimizer=dict(optimizer=optimizer, learning_rate=1e-3)))
    mc = PCFG
    batch = random_train_batch(mc, tc, "cpu")
    step_fn = make_train_step(mc, tc, device="cpu")
    whole = random_train_state(mc, tc, "cpu", seed=3)
    for _ in range(3):
        whole, _ = step_fn(whole, batch)
    part = random_train_state(mc, tc, "cpu", seed=3)
    for _ in range(2):
        part, _ = step_fn(part, batch)
    saver = pckpt.TrainCheckpointer(str(tmp_path / "state"))
    saver.save(2, part)
    saved = _snapshot(part)
    fresh = random_train_state(mc, tc, "cpu", seed=4)
    restored, at = saver.restore(fresh)
    assert at == 2 and restored is fresh
    _assert_states_equal(_snapshot(fresh), saved)
    assert pckpt._counters(fresh) == pckpt._counters(part)
    fresh, _ = step_fn(fresh, batch)
    _assert_states_equal(_snapshot(fresh), _snapshot(whole))
    assert pckpt._counters(fresh) == pckpt._counters(whole) and fresh.step == 3


def test_train_checkpointer_retention_async_and_strictness(tmp_path):
    """``max_to_keep`` keeps the newest files; an async save writes what a
    synchronous one does (after ``wait``), from a snapshot taken before it
    returned; a state of another structure is refused."""
    tc = pconfig.TrainConfig.from_dict(TC_KW)
    state = random_train_state(PCFG, tc, "cpu", seed=5)
    sync = pckpt.TrainCheckpointer(str(tmp_path / "sync"), max_to_keep=2)
    for step in (1, 2, 3):
        state.step = step
        sync.save(step, state)
    assert sync.steps() == [2, 3] and sync.latest_step() == 3
    assert [r["step"] for r in sync.saves] == [1, 2, 3] and sync.saves[-1]["bytes"] == os.path.getsize(sync.path(3))
    asyn = pckpt.TrainCheckpointer(str(tmp_path / "async"), async_save=True)
    asyn.save(3, state)
    named = dict(state.unet.named_parameters())
    with torch.no_grad():
        named[state.trainable[0]].add_(1.0)  # after the snapshot: not in the file
    asyn.wait()
    assert not [n for n in os.listdir(tmp_path / "async") if n.endswith(".tmp")]
    want, got = _load(sync.path(3)), _load(asyn.path(3))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    other = random_train_state(PCFG, pconfig.TrainConfig.from_dict(dict(TC_KW, use_ema=False)), "cpu")
    with pytest.raises(KeyError, match="mismatch"):
        sync.restore(other)
    assert pckpt.TrainCheckpointer(str(tmp_path / "none")).restore(state) == (None, None)


# ---------------------------------------------------------------------------
# the driver against the JAX driver
# ---------------------------------------------------------------------------


@pytest.fixture
def numpy_preprocessing(monkeypatch):
    """Both datasets on their numpy path (the JAX one would take a
    ``csrc/`` library only when something built it)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)


def test_train_matches_jax_driver(env, jax_pipe, numpy_preprocessing, monkeypatch):
    """Both drivers, 2 steps on the same clips: the port's step fed the
    numbers the JAX driver's keys draw (``rng, step_rng = split(rng)`` per
    step).  Losses to 1e-4; the epoch adapter checkpoint's update to 1e-3
    of its largest change (lr 1 and Adam eps 1 make the updates smooth in
    the gradients and keep the largest far above the fp32 spacing of the
    weights)."""
    flags = dict(learning_rate=1.0, adam_epsilon=1.0, adam_weight_decay=0.0)
    jlosses = []
    jreal = jdriver.make_train_step

    def recording(*a, **k):
        fn = jreal(*a, **k)

        def step(state, batch, rng):
            state, m = fn(state, batch, rng)
            jlosses.append(float(m["loss"]))
            return state, m
        return step

    monkeypatch.setattr(jdriver, "make_train_step", recording)
    jargs = jdriver.parse_args(_argv(env, output_dir=os.path.join(env["root"], "jax"), task_name="parity", **flags))
    jresult = jdriver.train(jargs, model_config=JCFG)

    preal = pdriver.make_train_step
    lat = RES // PCFG.vae.spatial_scale_factor

    def feeding(model_config, tc, **k):
        fn = preal(model_config, tc, **k)
        rng = [jax.random.PRNGKey(tc.seed)]

        def step(state, batch):
            rng[0], step_rng = jax.random.split(rng[0])
            draws = _draws(step_rng, BATCH, FRAMES, lat, tc)
            return fn(state, batch, draws={k: np.asarray(v) for k, v in draws.items()})
        return step

    monkeypatch.setattr(pdriver, "make_train_step", feeding)
    presult = _train(env, task_name="parity", **flags)
    assert presult["global_step"] == jresult["global_step"] == 2 == len(jlosses)
    np.testing.assert_allclose(presult["losses"], jlosses, rtol=1e-4)
    np.testing.assert_allclose(presult["last_loss"], jresult["last_loss"], rtol=1e-4)
    name = os.path.join("parity", "epoch_1", "i2v_adapter", "diffusion_pytorch_model.safetensors")
    want = _load(os.path.join(env["root"], "jax", name))
    got = _load(os.path.join(env["root"], "port", name))
    init = jconvert.extract_i2v_adapter(jax_pipe.params["unet"], JCFG.unet)
    assert set(got) == set(want) == set(init)
    change = max(float(np.max(np.abs(want[k] - init[k]))) for k in want)
    assert change > 0
    for k in want:
        err = float(np.max(np.abs(got[k] - want[k])))
        assert err <= 1e-3 * change, f"{k}: {err} against the largest change {change}"


# (directory dtype, mixed precision) -> the JAX driver's master dtype
DTYPE_CASES = [("float32", "none"), ("float32", "bfloat16"), ("float16", "none"), ("float16", "bfloat16")]


@pytest.fixture(scope="module")
def typed_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("typed")
    cfg = pconfig.tiny_test_config()
    return {dt: write_port_dir(str(root / dt), cfg, seed=2, dtype=np.dtype(dt))["bytes"] and str(root / dt)
            for dt in ("float32", "float16")}


@pytest.mark.parametrize("disk,mixed", DTYPE_CASES, ids=[f"{d}-{m}" for d, m in DTYPE_CASES])
def test_train_state_dtypes_against_jax(env, typed_dirs, disk, mixed):
    """The recorded deviation, shown: the JAX driver keeps its trainable
    masters (and their Adam moments) in the dtype ``from_pretrained`` gave
    them (an fp32 file becomes bf16 under bfloat16, an fp16 file stays
    fp16); the port keeps fp32 masters and moments, rounded from the
    pipeline's compute dtype.  The values are equal except for an fp16
    file under bfloat16, where the port's start from the bf16 rounding of
    the fp16 values (at most 2^-8 of each value apart).  Frozen leaves:
    the pipeline's dtype in the port, the file's or bf16 in JAX."""
    argv = _argv(env, pretrained_model_path=typed_dirs[disk], mixed_precision=mixed)
    jargs = jdriver.parse_args(argv)
    jtc = jdriver.args_to_train_config(jargs)
    jcfg = jconfig.tiny_test_config()
    jpipe = JPipeline.from_pretrained(typed_dirs[disk], jcfg, jconfig.PipelineConfig(
        dtype="bfloat16" if mixed == "bfloat16" else "float32"))
    jst, _ = jstate.create_train_state(jpipe.params["unet"], jtc, 2)
    setup = pdriver.setup(pdriver.parse_args(argv + ["--device", "cpu"]), pconfig.tiny_test_config())
    tensors = pckpt.train_state_tensors(setup["state"])
    from flax.traverse_util import flatten_dict

    master = {"float32": {"none": "float32", "bfloat16": "bfloat16"},
              "float16": {"none": "float16", "bfloat16": "float16"}}[disk][mixed]
    jtrain = flatten_dict(jst.trainable, sep="/")
    jmu = flatten_dict(jst.opt_state[1][0].mu, sep="/")
    assert {str(np.asarray(v).dtype) for v in jtrain.values()} == {master}
    assert {str(np.asarray(v).dtype) for v in jmu.values()} == {master}
    worst = 0.0
    for k, v in jtrain.items():
        got = tensors["trainable/" + k]
        assert got.dtype == torch.float32 and setup["state"].opt_state.mu
        want = np.asarray(v, np.float32)
        if disk == "float16" and mixed == "bfloat16":
            np.testing.assert_array_equal(got.numpy(), torch.from_numpy(want).to(torch.bfloat16).float().numpy())
            worst = max(worst, float(np.max(np.abs(got.numpy() - want) / np.maximum(np.abs(want), 1e-30))))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    # bf16 keeps 8 significant bits: the rounding moves a value by at most 2^-8 of it
    assert worst <= 2.0 ** -8 and (worst > 0) == (disk == "float16" and mixed == "bfloat16")
    assert {t.dtype for t in setup["state"].opt_state.mu.values()} == {torch.float32}
    frozen = {str(tensors["frozen/" + k].dtype) for k in flatten_dict(jst.frozen, sep="/")}
    assert frozen == {"torch.bfloat16" if mixed == "bfloat16" else "torch.float32"}


# ---------------------------------------------------------------------------
# the driver's own behaviour
# ---------------------------------------------------------------------------


def test_epoch_resume_and_ema_export(env):
    """With ``--use_ema`` the epoch checkpoint holds the EMA, the live
    weights go to ``non_ema/``, the final export holds the EMA; a second
    run finds ``epoch_1`` and resumes after it, its third step profiled
    (``--profile_steps 1``: a Chrome trace)."""
    result = _train(env, task_name="ema", use_ema=True, learning_rate=1e-2)
    assert result["global_step"] == 2 and all(np.isfinite(result["losses"]))
    epoch_dir = os.path.join(env["root"], "port", "ema", "epoch_1")
    ema = _load(os.path.join(epoch_dir, "i2v_adapter", "diffusion_pytorch_model.safetensors"))
    raw = _load(os.path.join(epoch_dir, "non_ema", "i2v_adapter", "diffusion_pytorch_model.safetensors"))
    assert set(ema) == set(raw)
    assert max(float(np.abs(ema[k] - raw[k]).max()) for k in ema if "to_q" in k or "to_out" in k) > 0
    unet = _load(os.path.join(env["root"], "port", "ema", "pipeline", "unet", "flax_model.safetensors"))
    key = next(k for k in ema if "to_q" in k)
    flax = [v for k, v in unet.items() if "i2v_adapter/to_q" in k]
    assert any(np.array_equal(v, ema[key].T) for v in flax), key
    with open(os.path.join(env["root"], "port", "ema", "pipeline", "train_config.json")) as f:
        assert json.load(f)["use_ema"] is True
    again = _train(env, task_name="ema", use_ema=True, num_train_epochs=2, max_train_steps=4, profile_steps=1)
    assert again["global_step"] == 4 and len(again["losses"]) == 2
    assert os.path.getsize(os.path.join(env["root"], "port", "ema", "profile", "trace.json")) > 0


def test_text_padding_longest_and_t2i(env):
    """``--text_padding longest`` (prompts of 3 tokens, bucketed to 8) and
    t2i mode (single frames, the whole UNet trains, its export per epoch)."""
    result = _train(env, task_name="longest", text_padding="longest")
    assert result["global_step"] == 2 and all(np.isfinite(result["losses"]))
    result = _train(env, task_name="t2i", train_mode="t2i")
    assert result["global_step"] == 2 and all(np.isfinite(result["losses"]))
    unet = _load(os.path.join(env["root"], "port", "t2i", "epoch_1", "unet", "flax_model.safetensors"))
    assert unet and not any("i2v_adapter" in k or "motion_modules" in k for k in unet)


def test_validation_sample_equals_fresh_pipeline(env, monkeypatch):
    """The validation sample (EMA weights swapped in, int8 serving convs)
    equals a pipeline built from the final export, bit for bit; the int8
    convs of the whole run are the validation clip's, site for site, as
    ``chip_smoke.validation_int8_launches`` and the sites it checks derive
    them (the training steps ran exact convs)."""
    samples, sites = [], {}
    real, real_conv = pdriver._run_validation, player.int8_conv

    def keep(*a, **k):
        samples.extend(real(*a, **k))
        return samples

    def counting(x, kernel, bias, stride=1, padding=1, absmax=None):
        key = (stride, x.shape[1], x.shape[3], kernel.shape[-1])
        sites[key] = sites.get(key, 0) + 1
        return real_conv(x, kernel, bias, stride, padding, absmax=absmax)

    monkeypatch.setattr(pdriver, "_run_validation", keep)
    monkeypatch.setattr(player, "int8_conv", counting)
    _train(env, task_name="val", use_ema=True, learning_rate=1e-2, validation_epoch=1,
           eval_csv_path=env["eval_csv"], n_frames=2)
    steps, lat = chip_smoke.clip_denoise_steps(chip_smoke.VALIDATION_STEPS), RES // PCFG.vae.spatial_scale_factor
    ucfg, derived = PCFG.unet.replace(int8_conv=True), {}
    for stride, weight, found in ((1, steps, chip_smoke.int8_unet_sites(ucfg, lat)),
                                  (2, steps, chip_smoke.int8_downsample_sites(ucfg, lat)),
                                  (1, 1, chip_smoke.int8_decoder_sites(PCFG.vae, lat))):
        for h, c, co, n in found:
            derived[(stride, h, c, co)] = derived.get((stride, h, c, co), 0) + weight * n
    assert sites == derived
    want = chip_smoke.validation_int8_launches(PCFG, lat)
    assert sum(n for k, n in sites.items() if k[0] == 1) == want["int8_conv3x3_kernel"]
    assert sum(n for k, n in sites.items() if k[0] == 2) == want["int8_matmul"]
    task = os.path.join(env["root"], "port", "val")
    assert len(samples) == 1 and os.path.exists(os.path.join(task, "samples_epoch_1", "sample_0_0.gif"))
    with open(os.path.join(task, "pipeline", "model_config.json")) as f:
        cfg = pconfig.I2VModelConfig.from_dict(json.load(f))
    from i2v_adapter_tpu_torch.utils.tokenizer import CLIPTokenizer
    from PIL import Image

    fresh = I2VAdapterPipeline(cfg, pckpt.load_pipeline_params(os.path.join(task, "pipeline")),
                               CLIPTokenizer.from_pretrained(os.path.join(env["pretrained"], "tokenizer")),
                               pconfig.PipelineConfig(dtype="float32"), device="cpu")
    with open(env["eval_csv"]) as f:
        row = next(csv.DictReader(f))
    video = fresh(row["prompt"], condition_image=Image.open(row["image_path"]), num_frames=2, height=RES,
                  width=RES, num_inference_steps=25, seed=0)
    np.testing.assert_array_equal(video, samples[0])


def test_overfit_one_clip(env):
    """One clip through the port's WebVid path, eight steps on the same
    draws: the loss falls, every trainable moves, no frozen weight does."""
    from i2v_adapter_tpu_torch.data import WebVidDataset

    tc = pconfig.TrainConfig(train_batch_size=1, num_frames=FRAMES, resolution=RES, gradient_accumulation_steps=1,
                             mixed_precision="none", optimizer=pconfig.OptimizerConfig(learning_rate=3e-3))
    item = WebVidDataset(env["csv"], env["videos"], sample_size=RES, sample_stride=2, sample_n_frames=FRAMES,
                         clip_image_size=PCFG.image_encoder.image_size, seed=0)[0]
    state = random_train_state(PCFG, tc, "cpu", seed=7)
    batch = {"pixel_values": item["pixel_values"][None], "clip_image": item["clip_image"][None],
             "text_ids": np.arange(16, dtype=np.int32)[None], "uncond_ids": np.zeros((1, 16), np.int32)}
    step_fn = make_train_step(PCFG, tc, device="cpu")
    draws = step_fn.draws(state, batch)
    draws["timesteps"] = torch.tensor([500])
    start = {n: p.detach().clone() for n, p in state.trainable_params().items()}
    named = dict(state.unet.named_parameters())
    frozen = {n: named[n].detach().clone() for n in state.frozen}
    losses = []
    for _ in range(8):
        state, m = step_fn(state, batch, draws=draws)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.9 * losses[0] and losses[-1] < min(losses[:4]), losses
    assert all(not torch.equal(p.detach(), start[n]) for n, p in state.trainable_params().items())
    assert all(torch.equal(named[n].detach(), v) for n, v in frozen.items())
