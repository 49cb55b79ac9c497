"""PyTorch port vs the JAX package: the host data path of the trainer.

* ``WebVidDataset`` items (pixels, CLIP image, caption) equal to the JAX
  dataset's bit for bit on the same CSV and seed, read in the same order
  (one thread), with the native preprocessing on both sides (both loading
  the library the port builds from ``csrc/preprocess.cpp``) and with the
  numpy path on both sides; in clip and image mode, with a broken row
  retried, per shard;
* ``_read_video_frames``' indexed reads against a sequential decode;
* the native library's outputs against the JAX binding's, bit for bit;
* ``DataLoader`` batches and their order over two epochs against the JAX
  loader's, ``ShardedBatcher``, ``default_collate``;
* ``MetricsLogger.read()`` records, ``StepTimer``, the profiler's trace.

The decode cases need OpenCV (skipped without it, as the JAX package's
own tests are).
"""

import csv
import os

import numpy as np
import pytest

from i2v_adapter_tpu.data import loader as jloader
from i2v_adapter_tpu.data import native as jnative
from i2v_adapter_tpu.data import webvid as jwebvid
from i2v_adapter_tpu.utils import metrics as jmetrics
from i2v_adapter_tpu_torch.data import loader as ploader
from i2v_adapter_tpu_torch.data import native as pnative
from i2v_adapter_tpu_torch.data import webvid as pwebvid
from i2v_adapter_tpu_torch.utils import metrics as pmetrics
from tests.torch_port_common import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("port_videos")
    rng = np.random.default_rng(0)
    rows = []
    for i, (vid, n_frames, size) in enumerate((("aaa", 40, (64, 48)), ("bbb", 12, (48, 64)),
                                                ("ccc", 24, (50, 50)), ("ddd", 30, (72, 40)))):
        page = root / f"page{i % 2}"
        page.mkdir(exist_ok=True)
        w = cv2.VideoWriter(str(page / f"{vid}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, size)
        if not w.isOpened():
            pytest.skip("cv2 VideoWriter lacks mp4 support here")
        for t in range(n_frames):
            frame = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
            frame[:, :, 0] = t * 5  # frame index signature
            w.write(frame)
        w.release()
        rows.append({"videoid": vid, "name": f"clip {vid}", "page_dir": page.name})
    rows.insert(2, {"videoid": "missing", "name": "broken", "page_dir": "page0"})
    csv_path = str(root / "train.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["videoid", "name", "page_dir"])
        writer.writeheader()
        writer.writerows(rows)
    return str(root), csv_path


@pytest.fixture
def preprocessing(request, monkeypatch):
    """Both packages on the native library (the one the port builds; the
    JAX binding pointed at it, so nothing is written into ``csrc/``) or
    both on numpy."""
    if request.param == "native":
        path = pnative.library_path() if pnative.available() else None
        if path is None:
            pytest.skip("no C++ compiler: the native library is unavailable")
        monkeypatch.setattr(jnative, "_csrc_dir", lambda: os.path.dirname(path))
        monkeypatch.setattr(jnative, "_LIB_NAME", os.path.basename(path))
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_load_failed", False)
        assert jnative.available()
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(pnative, "available", lambda: False)
    return request.param


def _datasets(video_dir, **kw):
    root, csv_path = video_dir
    kw = dict(dict(sample_size=32, sample_stride=2, sample_n_frames=4, clip_image_size=28, seed=3), **kw)
    return jwebvid.WebVidDataset(csv_path, root, **kw), pwebvid.WebVidDataset(csv_path, root, **kw)


def _assert_items_equal(jds, pds, order):
    for idx in order:
        want, got = jds[idx], pds[idx]
        assert set(got) == set(want) == {"pixel_values", "clip_image", "text"}
        assert got["text"] == want["text"]
        for key in ("pixel_values", "clip_image"):
            assert got[key].dtype == want[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"item {idx} {key}")


@pytest.mark.parametrize("preprocessing", ["native", "numpy"], indirect=True)
@pytest.mark.parametrize("mode", ["clip", "image"])
def test_webvid_items_match_jax(video_dir, preprocessing, mode):
    """Every row (the broken one retried with a random substitute) twice
    over, in the same order: the same clip starts, flips and substitutes
    from the same ``random.Random(seed)``, the same bits."""
    jds, pds = _datasets(video_dir, is_image=mode == "image")
    assert pds.preprocess == preprocessing
    _assert_items_equal(jds, pds, list(range(len(pds))) * 2)
    shape = (32, 32, 3) if mode == "image" else (4, 32, 32, 3)
    item = pds[0]
    assert item["pixel_values"].shape == shape and item["clip_image"].shape == (28, 28, 3)
    assert -1.0 <= item["pixel_values"].min() and item["pixel_values"].max() <= 1.0


@pytest.mark.parametrize("preprocessing", ["native", "numpy"], indirect=True)
def test_webvid_sharding_and_clamp_match_jax(video_dir, preprocessing):
    """Per-process stripes of the rows, and a clip longer than a video
    clamped to the video's length (12 frames at stride 8)."""
    for shard in range(2):
        jds, pds = _datasets(video_dir, shard=shard, num_shards=2)
        assert pds.rows == jds.rows
        _assert_items_equal(jds, pds, range(len(pds)))
    jds, pds = _datasets(video_dir, sample_stride=8, sample_n_frames=6)
    _assert_items_equal(jds, pds, [1, 1, 0])


def test_read_video_frames_indexed_matches_sequential(video_dir, monkeypatch):
    """Seeks past gaps (forced at 2 frames) return the frames a sequential
    decode reads; equal to the JAX reader's; ``video_length``."""
    import cv2

    root, _ = video_dir
    path = os.path.join(root, "page0", "aaa.mp4")
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    cap.release()
    assert pwebvid.video_length(path) == jwebvid.video_length(path) == len(frames) == 40
    monkeypatch.setattr(pwebvid, "_SEEK_GAP", 2)
    for indices in ([0, 5, 10, 35], [20, 25, 30], [3, 3, 9], [39]):
        got = pwebvid._read_video_frames(path, np.asarray(indices))
        np.testing.assert_array_equal(got, np.stack([frames[i] for i in indices]))
        np.testing.assert_array_equal(got, jwebvid._read_video_frames(path, np.asarray(indices)))
    with pytest.raises(IOError):
        pwebvid._read_video_frames(os.path.join(root, "page0", "missing.mp4"), np.arange(2))


def test_native_library_matches_jax_binding(monkeypatch):
    """The port's build of ``csrc/preprocess.cpp`` through both bindings:
    [-1, 1] and CLIP preprocessing and the flip, bit for bit; the build is
    keyed by the source, the flags and the CPU."""
    if not pnative.available():
        pytest.skip("no C++ compiler: the native library is unavailable")
    path = pnative.library_path()
    assert os.path.exists(path) and os.path.dirname(path) == pnative.BUILD
    monkeypatch.setattr(jnative, "_csrc_dir", lambda: os.path.dirname(path))
    monkeypatch.setattr(jnative, "_LIB_NAME", os.path.basename(path))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (3, 50, 30, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pnative.preprocess_frames_pm1(frames, 24), jnative.preprocess_frames_pm1(frames, 24))
    np.testing.assert_array_equal(pnative.preprocess_frames_clip(frames, 28),
                                  jnative.preprocess_frames_clip(frames, 28))
    x = rng.random((2, 4, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(pnative.hflip_frames(x.copy()), x[:, :, ::-1])


class _Indexed:
    """A dataset of arrays and strings that records nothing random."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32), "t": f"item {i}"}


@pytest.mark.parametrize("kw", [dict(batch_size=3, num_workers=1), dict(batch_size=3, num_workers=4),
                                dict(batch_size=4, num_workers=2, drop_last=False),
                                dict(batch_size=2, num_workers=3, shuffle=False)],
                         ids=["one_thread", "four_threads", "keep_last", "no_shuffle"])
def test_data_loader_matches_jax(kw):
    """Two epochs (the per-epoch reshuffle from ``seed + epoch``): the same
    batches in the same order, whatever the threads; ``len``."""
    jl, pl = jloader.DataLoader(_Indexed(11), seed=5, **kw), ploader.DataLoader(_Indexed(11), seed=5, **kw)
    assert len(pl) == len(jl)
    for _ in range(2):
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == len(pl)
        for g, w in zip(got, want):
            assert g["t"] == w["t"]
            np.testing.assert_array_equal(g["x"], w["x"])


def test_data_loader_reads_ahead_boundedly():
    """At most ``prefetch + num_workers`` batches are decoded ahead of the
    consumer (the JAX loader decodes the whole epoch ahead)."""
    import threading
    import time

    class Counting(_Indexed):
        def __init__(self, n):
            super().__init__(n)
            self.calls, self.lock = 0, threading.Lock()

        def __getitem__(self, i):
            with self.lock:
                self.calls += 1
            return super().__getitem__(i)

    ds = Counting(200)
    batches = iter(ploader.DataLoader(ds, 2, num_workers=3, prefetch=2, seed=0))
    first = next(batches)
    time.sleep(0.3)
    assert first["x"].shape == (2, 2, 3)
    assert ds.calls <= 2 * (1 + 2 + 3)
    assert len(list(batches)) == 99 and ds.calls == 200


@pytest.mark.parametrize("preprocessing", ["native", "numpy"], indirect=True)
def test_data_loader_over_webvid_matches_jax(video_dir, preprocessing):
    """The loader over the WebVid dataset with one thread, two epochs."""
    jds, pds = _datasets(video_dir)
    jl, pl = jloader.DataLoader(jds, 2, num_workers=1, seed=1), ploader.DataLoader(pds, 2, num_workers=1, seed=1)
    for _ in range(2):
        for g, w in zip(list(pl), list(jl)):
            assert g["text"] == w["text"]
            np.testing.assert_array_equal(g["pixel_values"], w["pixel_values"])
            np.testing.assert_array_equal(g["clip_image"], w["clip_image"])


def test_sharded_batcher_and_collate_match_jax():
    for index in range(2):
        want = list(jloader.ShardedBatcher(jloader.DataLoader(_Indexed(8), 4, seed=2), index, 2))
        got = list(ploader.ShardedBatcher(ploader.DataLoader(_Indexed(8), 4, seed=2), index, 2))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["t"] == w["t"]
            np.testing.assert_array_equal(g["x"], w["x"])
    with pytest.raises(ValueError):
        ploader.ShardedBatcher(ploader.DataLoader(_Indexed(8), 3), 0, 2)
    samples = [_Indexed(3)[i] for i in range(3)]
    got, want = ploader.default_collate(samples), jloader.default_collate(samples)
    assert got["t"] == want["t"] and np.array_equal(got["x"], want["x"])


def test_metrics_logger_records_match_jax(tmp_path):
    """The same JSONL records (``time`` aside), read back the same way;
    TensorBoard events where ``torch.utils.tensorboard`` imports."""
    logs = {}
    for name, mod in (("jax", jmetrics), ("port", pmetrics)):
        log = mod.MetricsLogger(str(tmp_path / name), use_tensorboard=name == "port")
        for step in (10, 20):
            log.log(step, {"train_loss": 0.5 / step, "grad_norm": 1.0 + step, "steps_per_sec": 2.0})
        log.finish()
        logs[name] = [{k: v for k, v in r.items() if k != "time"} for r in log.read()]
    assert logs["port"] == logs["jax"] and len(logs["port"]) == 2
    assert pmetrics.MetricsLogger(str(tmp_path / "empty"), use_tensorboard=False).read() == []


def test_step_timer_and_profiler(tmp_path):
    """The first step is kept apart and left out of the mean, as in the JAX
    timer; the profiler writes a Chrome trace of its step range."""
    import time

    timers = [jmetrics.StepTimer(), pmetrics.StepTimer("cpu")]
    for pause in (0.03, 0.01, 0.01):
        for t in timers:
            with t:
                time.sleep(pause)
    for t in timers:
        assert t.compile_time >= 0.03 and 0.01 <= t.mean < 0.03 and t.rate == pytest.approx(1 / t.mean)
    prof = pmetrics.Profiler(str(tmp_path / "profile"), 1, 2)
    for step in range(4):
        prof.step(step)
        sum(range(1000))
    assert prof.trace_path is not None and os.path.getsize(prof.trace_path) > 0
