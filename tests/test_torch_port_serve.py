"""The serving entry points of the port: the directory-queue daemon, the
CLI, ``find_latest_epoch`` and the ``__call__`` serving options, at the tiny
config on the CPU (2 frames, 32 px, 2 steps), mirroring
``tests/test_serve.py`` and ``tests/test_cli.py``.

* the queue drains and isolates failures (a missing image, malformed
  JSON), ``encoder_cache: 2``, ``dispatch: "scan"`` and ``dispatch:
  "stepwise"`` requests run, and outputs equal a direct call;
* a request that runs out of device memory fails alone;
* the per-request timeout fails a hanging request and recycles the worker;
* the argparse surfaces equal the JAX package's (dests and defaults),
  apart from ``--device``; ``--mesh`` refuses more ranks than cards and a
  mesh that is not ``data,tensor,seq``;
* ``find_latest_epoch`` against JAX;
* ``cli.main`` on a one-row CSV with an adapter task written by the port's
  writer produces the GIF;
* ``__call__``: ``dispatch`` 'auto' / 'stepwise' / 'scan' run (equal);
  ``encoder_cache`` / ``cfg_cutoff`` off runs, the approximations
  run (here one denoise step: ``encoder_cache=2``'s odd trailing step is the
  exact one, ``cfg_cutoff=0.5`` rounds to no CFG step), values outside the
  reference's domain ValueError.
"""

import csv
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from i2v_adapter_tpu.pipelines import cli as jcli
from i2v_adapter_tpu.pipelines import serve as jserve
from i2v_adapter_tpu.training.checkpoint import find_latest_epoch as j_find_latest_epoch
from i2v_adapter_tpu_torch.config import PipelineConfig, tiny_test_config
from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline, cli, serve
from i2v_adapter_tpu_torch.training.checkpoint import find_latest_epoch
from tests import synth
from tests import torch_port_synth as psynth
from tests.torch_port_common import one_torch_thread  # noqa: F401

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

# tests/synth.py's unscaled weights need the exact softmax (see
# test_torch_port_convert.py)
CFG = tiny_test_config()
CFG = CFG.replace(unet=CFG.unet.replace(flash_static_max=0.0))
SMALL = ["--num_frames", "2", "--height", "32", "--width", "32", "--num_inference_steps", "2",
         "--dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    pretrained = synth.write_pretrained_dir(str(root / "sd"), np.random.default_rng(0))
    pc = PipelineConfig(num_frames=2, height=32, width=32, num_inference_steps=2, dtype="float32",
                        blur_sigma=1.0)
    pipe = I2VAdapterPipeline.from_pretrained(pretrained, model_config=CFG, pipeline_config=pc, device="cpu")
    image = str(root / "cond.png")
    Image.fromarray((np.random.default_rng(0).random((32, 32, 3)) * 255).astype(np.uint8)).save(image)
    return {"root": root, "pretrained": pretrained, "pipe": pipe, "image": image}


def queue(req_dir, reqs):
    os.makedirs(req_dir, exist_ok=True)
    for i, (rid, req) in enumerate(reqs.items()):
        path = os.path.join(req_dir, rid + ".json")
        with open(path, "w") as f:
            f.write(req if isinstance(req, str) else json.dumps(req))
        t = time.time() + i  # distinct mtimes: a deterministic queue order
        os.utime(path, (t, t))


def result(out_dir, rid):
    with open(os.path.join(out_dir, rid + ".result.json")) as f:
        return json.load(f)


def test_serve_drains_queue_and_isolates_failures(setup, tmp_path):
    pipe, img = setup["pipe"], setup["image"]
    req_dir, out_dir = str(tmp_path / "requests"), str(tmp_path / "output")
    queue(req_dir, {
        "a_good": {"prompt": "a cat", "image": img, "seed": 3, "format": "npy"},
        "b_missing_image": {"prompt": "x", "image": str(tmp_path / "missing.png")},
        "c_malformed": "{not json",
        "d_encoder_cache": {"prompt": "a cat", "image": img, "seed": 3, "encoder_cache": 2, "format": "npy"},
        "e_scan": {"prompt": "a cat", "image": img, "seed": 4, "dispatch": "scan", "format": "npy"},
        "f_stepwise": {"prompt": "a dog", "image": img, "seed": 4, "dispatch": "stepwise", "format": "npy"},
        "g_gif": {"prompt": "a dog", "image": img},
    })
    assert serve.serve(pipe, req_dir, out_dir, max_requests=10) == 7
    r = result(out_dir, "a_good")
    assert r["ok"] and r["shape"] == [1, 2, 32, 32, 3] and r["latency_s"] >= 0
    video = np.load(os.path.join(out_dir, "a_good.npy"))
    np.testing.assert_array_equal(video, pipe("a cat", condition_image=Image.open(img), seed=3))
    stepwise = np.load(os.path.join(out_dir, "f_stepwise.npy"))
    np.testing.assert_array_equal(stepwise, pipe("a dog", condition_image=Image.open(img), seed=4))
    cached = np.load(os.path.join(out_dir, "d_encoder_cache.npy"))
    np.testing.assert_array_equal(cached, pipe("a cat", condition_image=Image.open(img), seed=3, encoder_cache=2))
    scan = np.load(os.path.join(out_dir, "e_scan.npy"))
    np.testing.assert_array_equal(scan, pipe("a cat", condition_image=Image.open(img), seed=4, dispatch="stepwise"))
    for rid, error in (("b_missing_image", "FileNotFoundError"), ("c_malformed", "JSONDecodeError")):
        r = result(out_dir, rid)
        assert not r["ok"] and r["error"].startswith(error), (rid, r)
    assert result(out_dir, "g_gif")["ok"]
    with Image.open(os.path.join(out_dir, "g_gif_0.gif")) as gif:
        assert gif.n_frames == 2 and gif.size == (32, 32)
    assert sorted(os.listdir(req_dir)) == [
        "a_good.json.done", "b_missing_image.json.failed", "c_malformed.json.failed",
        "d_encoder_cache.json.done", "e_scan.json.done", "f_stepwise.json.done", "g_gif.json.done"]


def test_serve_refuses_over_envelope_and_serves_on(setup, tmp_path):
    """A request over the card's memory envelope fails with the envelope's
    ValueError in its result JSON, before anything runs, and the next
    request serves (the JAX ``tests/test_serve.py`` behaviour)."""
    req_dir, out_dir = str(tmp_path / "requests"), str(tmp_path / "output")
    queue(req_dir, {"a_huge": {"prompt": "x", "image": setup["image"], "height": 4096, "width": 4096},
                    "b_next": {"prompt": "a cat", "image": setup["image"], "format": "npy"}})
    assert serve.serve(setup["pipe"], req_dir, out_dir, max_requests=5) == 2
    r = result(out_dir, "a_huge")
    assert not r["ok"] and r["error"].startswith("ValueError: request of") and "memory envelope" in r["error"]
    assert result(out_dir, "b_next")["ok"]


class _OutOfMemoryOnce:
    """The real pipeline, whose first call fails as a card out of memory
    fails; counts the daemon's drops of its kept step graphs."""

    def __init__(self, pipe):
        self.pipe, self.failed, self.released = pipe, False, 0

    def release_graphs(self):
        self.released += 1
        self.pipe.release_graphs()

    def __call__(self, *a, **k):
        if not self.failed:
            self.failed = True
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB")
        return self.pipe(*a, **k)

    def export_gifs(self, *a, **k):
        return self.pipe.export_gifs(*a, **k)


def test_serve_survives_out_of_memory(setup, tmp_path):
    req_dir, out_dir = str(tmp_path / "requests"), str(tmp_path / "output")
    queue(req_dir, {rid: {"prompt": "a cat", "image": setup["image"], "format": "npy"}
                    for rid in ("a_oom", "b_next")})
    oom = _OutOfMemoryOnce(setup["pipe"])
    assert serve.serve(oom, req_dir, out_dir, max_requests=5) == 2
    assert oom.released == 1  # after the failed request only
    r = result(out_dir, "a_oom")
    assert not r["ok"] and r["error"].startswith("OutOfMemoryError: CUDA out of memory")
    assert result(out_dir, "b_next")["ok"]
    assert sorted(os.listdir(req_dir)) == ["a_oom.json.failed", "b_next.json.done"]


class _HangingPipe:
    """A pipeline whose call blocks far past the timeout (a request wedged
    on the device): poison isolation cannot catch it, the call never
    returns."""

    def __init__(self):
        self.release = threading.Event()

    def __call__(self, *a, **k):
        self.release.wait(60)

    def release_graphs(self):
        pass

    def export_gifs(self, *a, **k):  # pragma: no cover - never reached
        raise AssertionError("hanging pipe should never produce output")


def test_serve_request_timeout_recycles_worker(setup, tmp_path):
    req_dir, out_dir = str(tmp_path / "requests"), str(tmp_path / "output")
    queue(req_dir, {rid: {"prompt": "x", "image": setup["image"], "format": "npy"}
                    for rid in ("a_hang", "b_good")})
    hanging = _HangingPipe()
    try:
        assert serve.serve(hanging, req_dir, out_dir, max_requests=5, request_timeout=0.5) == 1
    finally:
        hanging.release.set()
    r = result(out_dir, "a_hang")
    assert not r["ok"] and "RequestTimeout" in r["error"]
    assert sorted(os.listdir(req_dir)) == ["a_hang.json.failed", "b_good.json"]
    # a restarted worker drains the queue; a request under the bound is unaffected
    assert serve.serve(setup["pipe"], req_dir, out_dir, max_requests=5, request_timeout=600.0) == 1
    assert result(out_dir, "b_good")["ok"] and os.path.exists(os.path.join(out_dir, "b_good.npy"))


ARGVS = [
    [],
    ["--requests_dir", "r", "--output_dir", "o", "--max_requests", "2", "--no-int8_conv",
     "--task_name", "t", "--checkpoint_epoch", "3", "--request_timeout", "9", "--dtype", "float32"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "flags"])
def test_argparse_surfaces_match_jax(argv):
    """The daemon's and the CLI's dests and defaults equal the JAX
    package's, apart from the port's ``--device``."""
    base = ["--pretrained_model_path", "p"]
    got, want = vars(serve.parse_args(base + argv)), vars(jserve.parse_args(base + argv))
    assert got.pop("device") is None and got == want
    cli_argv = base + ["--task_name", "t", "--eval_csv_path", "e.csv"] + (
        ["--dispatch", "stepwise", "--no-int8_conv", "--cfg_cutoff", "0.5", "--seed", "2"] if argv else [])
    got, want = vars(cli.parse_args(cli_argv)), vars(jcli.parse_args(cli_argv))
    assert got.pop("device") is None and got == want
    assert serve.parse_args(base + ["--device", "cpu"]).device == "cpu"


def test_mesh_is_refused(setup, tmp_path):
    """``--mesh`` serves (``tests/test_torch_port_mesh.py``); what it cannot
    run is refused before anything loads: more ranks than the host has
    cards, and a mesh that is not ``data,tensor,seq``."""
    with pytest.raises(ValueError, match="needs 64 cards"):
        serve.main(["--pretrained_model_path", setup["pretrained"], "--mesh", "16,2,2"])
    with pytest.raises(ValueError, match="data,tensor,seq"):
        serve.main(["--pretrained_model_path", setup["pretrained"], "--mesh", "2,2", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 64 cards"):
        cli.main(["--task_name", "t", "--pretrained_model_path", setup["pretrained"],
                  "--eval_csv_path", str(tmp_path / "e.csv"), "--mesh", "16,2,2"])
    with pytest.raises(ValueError, match="data,tensor,seq"):
        cli.main(["--task_name", "t", "--pretrained_model_path", setup["pretrained"],
                  "--eval_csv_path", str(tmp_path / "e.csv"), "--mesh", "1,x,2", "--device", "cpu"])


LAYOUTS = {"missing": None, "empty": [], "one": ["epoch_1"],
           "several": ["epoch_2", "epoch_10", "epoch_9", "epoch_x", "notes", "epoch_3.bak"]}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_find_latest_epoch_matches_jax(tmp_path, layout):
    task = tmp_path / "task"
    if LAYOUTS[layout] is not None:
        task.mkdir()
        for name in LAYOUTS[layout]:
            (task / name).mkdir()
    assert find_latest_epoch(str(task)) == j_find_latest_epoch(str(task))
    assert find_latest_epoch(str(task)) == {"missing": None, "empty": None, "one": 1, "several": 10}[layout]


def test_cli_writes_gif_with_adapter_task(setup, tmp_path):
    adapter = psynth.write_adapter_task(str(tmp_path / "checkpoint"), "task", CFG, epoch=2)
    assert serve.adapter_checkpoint(str(tmp_path / "checkpoint"), "task", None) == adapter
    eval_csv = str(tmp_path / "eval.csv")
    with open(eval_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["prompt", "image_path"])
        w.writeheader()
        w.writerow({"prompt": "a cat", "image_path": setup["image"]})
    out = cli.main(["--task_name", "task", "--checkpoint_dir", str(tmp_path / "checkpoint"),
                    "--pretrained_model_path", setup["pretrained"], "--eval_csv_path", eval_csv,
                    "--output_dir", str(tmp_path / "samples"), "--no-int8_conv"] + SMALL, model_config=CFG)
    assert out == [str(tmp_path / "samples" / "task_0_0.gif")]
    with Image.open(out[0]) as gif:
        assert gif.n_frames == 2 and gif.size == (32, 32)


# (call arguments, what the call gives: the same latents as the default call,
# other latents, or an error)
CALL_CASES = {
    "dispatch_auto": (dict(dispatch="auto"), "same"),
    "dispatch_stepwise": (dict(dispatch="stepwise"), "same"),
    "dispatch_scan": (dict(dispatch="scan"), "same"),
    "dispatch_unknown": (dict(dispatch="fused"), ValueError),
    "encoder_cache_off": (dict(encoder_cache=1), "same"),
    "encoder_cache_2": (dict(encoder_cache=2), "same"),  # one step: the trailing full step
    "encoder_cache_3": (dict(encoder_cache=3), ValueError),
    "cfg_cutoff_off": (dict(cfg_cutoff=1.0), "same"),
    "cfg_cutoff_half": (dict(cfg_cutoff=0.5), "other"),  # round(0.5) = 0: cond-only
    "cfg_cutoff_out_of_range": (dict(cfg_cutoff=1.5), ValueError),
}


@pytest.mark.parametrize("case", sorted(CALL_CASES))
def test_call_serving_options(setup, case):
    kwargs, expect = CALL_CASES[case]
    pipe, image = setup["pipe"], np.asarray(Image.open(setup["image"]))
    call = lambda **kw: pipe("a cat", condition_image=image, seed=5, output_type="latent", **kw)  # noqa: E731
    if expect not in ("same", "other"):
        with pytest.raises(expect):
            call(**kwargs)
        return
    got, want = call(**kwargs), call()
    assert len(pipe.last_timings["step_ms"]) == 1 and np.isfinite(got).all()
    if expect == "same":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() > 0
