"""PyTorch port vs the JAX package: the offline tools on the CPU.

* ``encode_image``, ``encode_text`` and ``encode_video`` against the JAX
  tools on the same image / video folder and the same
  ``tests/torch_port_synth.py`` directory at ``tiny_test_config()`` widths
  (the JAX tools' ``VAEConfig`` / ``CLIPTextConfig`` replaced by the tiny
  ones, which they import inside the function): the fp16 outputs within
  2^-10 of max |JAX|, the text files and ``frames_per_video.npy`` equal;
  the outputs read back through the port's latent datasets;
* ``tools/parity.py``'s ``psnr`` / ``compare`` on the cases of
  ``tests/test_parity_tool.py``, against the JAX ones; ``golden`` without
  ``diffusers``;
* ``utils/image.py::save_image_grid`` against the JAX one, pixel for pixel.
"""

import os
import sys

import numpy as np
import pytest

from i2v_adapter_tpu import config as jconfig
from i2v_adapter_tpu.data import latent as jlatent
from i2v_adapter_tpu.tools import encode_image as j_encode_image
from i2v_adapter_tpu.tools import encode_text as j_encode_text
from i2v_adapter_tpu.tools import encode_video as j_encode_video
from i2v_adapter_tpu.tools import parity as jparity
from i2v_adapter_tpu.utils.image import save_image_grid as j_save_image_grid
from i2v_adapter_tpu_torch import config as pconfig
from i2v_adapter_tpu_torch.data import latent as platent
from i2v_adapter_tpu_torch.tools import encode_image, encode_text, encode_video, parity
from i2v_adapter_tpu_torch.utils.image import save_image_grid
from tests.torch_port_common import one_torch_thread  # noqa: F401
from tests.torch_port_synth import write_pretrained_dir

cv2 = pytest.importorskip("cv2")

TINY = pconfig.tiny_test_config()
FP16_TOL = 2.0 ** -10


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny pretrained directory, 5 images in 2 class folders (one of them
    unreadable), 3 clips (10, 7 and 12 frames) and a caption file."""
    root = tmp_path_factory.mktemp("port_tools")
    rng = np.random.default_rng(0)
    pretrained = str(root / "pretrained")
    write_pretrained_dir(pretrained, TINY, seed=3)
    from PIL import Image

    for i, (cls, size) in enumerate([("cat", (40, 30)), ("cat", (24, 24)), ("dog", (30, 50)), ("dog", (17, 33))]):
        (root / "images" / cls).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(root / "images" / cls / f"im{i}.png")
    (root / "images" / "dog" / "broken.png").write_bytes(b"not a png")
    for i, n in enumerate((10, 7, 12)):
        folder = root / "videos" / f"p{i % 2}"
        folder.mkdir(parents=True, exist_ok=True)
        w = cv2.VideoWriter(str(folder / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (40, 32))
        if not w.isOpened():
            pytest.skip("no mp4 writer")
        for _ in range(n):
            w.write(rng.integers(0, 256, (32, 40, 3), dtype=np.uint8))
        w.release()
    (root / "captions.txt").write_text("a cat\na dog on a hill\n\nthree words here\na cat")
    return {"root": root, "pretrained": pretrained}


@pytest.fixture
def tiny_jax_configs(monkeypatch):
    tiny = jconfig.tiny_test_config()
    monkeypatch.setattr(jconfig, "VAEConfig", lambda: tiny.vae)
    monkeypatch.setattr(jconfig, "CLIPTextConfig", lambda: tiny.text_encoder)


def _close16(got, want):
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
    g, w = got.astype(np.float32), want.astype(np.float32)
    assert float(np.abs(g - w).max()) <= FP16_TOL * float(np.abs(w).max())


def test_encode_image_matches_jax(data, tiny_jax_configs):
    root = data["root"]
    common = ["--image_folder", str(root / "images"), "--vae_path", os.path.join(data["pretrained"], "vae"),
              "--sample_size", "16", "--batch_size", "3"]
    j_encode_image.encode_images(common + ["--output_dir", str(root / "jax_images")])
    encode_image.encode_images(common + ["--output_dir", str(root / "port_images"), "--device", "cpu"],
                               model_config=TINY)
    got, want = (np.load(root / d / "latents.npy") for d in ("port_images", "jax_images"))
    assert got.shape == (4, 8, 8, 4)
    _close16(got, want)
    captions = (root / "port_images" / "captions.txt").read_text()
    assert captions == (root / "jax_images" / "captions.txt").read_text() == "im0\nim1\nim2\nim3"
    # the round trip: the port's dataset on the port's files vs the JAX one on the JAX files
    files = lambda d: (str(root / d / "latents.npy"), str(root / d / "captions.txt"))  # noqa: E731
    p, j = platent.LatentImageDataset(*files("port_images")), jlatent.LatentImageDataset(*files("jax_images"))
    assert len(p) == len(j) == 4
    bound = 2.0 / 0.18215
    for i in range(4):
        a, b = p[i], j[i]
        assert a["text"] == b["text"] and a["latents"].dtype == np.float32
        np.testing.assert_array_equal(a["latents"], np.clip(got[i].astype(np.float32), -bound, bound) / bound)
        assert float(np.abs(a["latents"] - b["latents"]).max()) <= FP16_TOL  # in [-1, 1]


def test_encode_text_matches_jax(data, tiny_jax_configs):
    root, pre = data["root"], data["pretrained"]
    common = ["--caption_file", str(root / "captions.txt"), "--text_encoder_path", os.path.join(pre, "text_encoder"),
              "--tokenizer_path", os.path.join(pre, "tokenizer"), "--batch_size", "2"]
    j_encode_text.encode_text(common + ["--output_path", str(root / "jax_embeds.npy")])
    encode_text.encode_text(common + ["--output_path", str(root / "port_embeds.npy"), "--device", "cpu"],
                            model_config=TINY)
    got, want = np.load(root / "port_embeds.npy"), np.load(root / "jax_embeds.npy")
    assert got.shape == (5, TINY.text_encoder.max_position_embeddings, TINY.text_encoder.hidden_size)
    _close16(got, want)


@pytest.mark.parametrize("scaled", [False, True])
def test_encode_video_matches_jax(data, tiny_jax_configs, scaled):
    root = data["root"]
    common = ["--video_folder", str(root / "videos"), "--vae_path", os.path.join(data["pretrained"], "vae"),
              "--sample_size", "16", "--slice_frames", "4", "--max_frames_per_video", "11"]
    common += ["--scaled"] if scaled else []
    tag = "scaled" if scaled else "raw"
    j_encode_video.encode_videos(common + ["--output_dir", str(root / f"jax_videos_{tag}")])
    encode_video.encode_videos(common + ["--output_dir", str(root / f"port_videos_{tag}"), "--device", "cpu"],
                               model_config=TINY)
    port, jax_out = root / f"port_videos_{tag}", root / f"jax_videos_{tag}"
    got, want = np.load(port / "latents.npy"), np.load(jax_out / "latents.npy")
    assert got.shape == (10 + 7 + 11, 8, 8, 4)
    _close16(got, want)
    fpv = np.load(port / "frames_per_video.npy")
    np.testing.assert_array_equal(fpv, np.load(jax_out / "frames_per_video.npy"))
    assert fpv.tolist() == [10, 11, 7]  # sorted paths: p0/clip0, p0/clip2, p1/clip1
    assert (port / "prompts.txt").read_text() == (jax_out / "prompts.txt").read_text() == "clip0\nclip2\nclip1"
    # the round trip through the video datasets, same seed, same windows
    kw = dict(caption_path=str(port / "prompts.txt"), sample_n_frames=8, seed=1)
    p = platent.LatentVideoDataset(str(port / "latents.npy"), str(port / "frames_per_video.npy"), **kw)
    kw["caption_path"] = str(jax_out / "prompts.txt")
    j = jlatent.LatentVideoDataset(str(jax_out / "latents.npy"), str(jax_out / "frames_per_video.npy"), **kw)
    assert len(p) == len(j) == 2 and p.videos == j.videos
    bound = 2.0 / 0.18215
    for i in (0, 1, 1, 0):
        a, b = p[i], j[i]
        assert a["text"] == b["text"] and a["latents"].shape == (8, 8, 8, 4)
        assert float(np.abs(a["latents"] - b["latents"]).max()) <= FP16_TOL  # in [-1, 1]


def test_encoders_default_to_the_card(data, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_image.encode_images(["--image_folder", str(data["root"] / "images"), "--vae_path",
                                    os.path.join(data["pretrained"], "vae"), "--output_dir",
                                    str(data["root"] / "never")], model_config=TINY)


# ---------------------------------------------------------------------------
# parity tool and image grid
# ---------------------------------------------------------------------------


def test_psnr_values():
    a = np.zeros((4, 4), np.float32)
    assert parity.psnr(a, a) == jparity.psnr(a, a) == float("inf")
    b = a + 0.01
    # mse = 1e-4, peak^2 = 4 -> 10*log10(4e4) ~ 46 dB
    assert abs(parity.psnr(a, b) - 46.02) < 0.1
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((3, 5)), rng.standard_normal((3, 5))
    for peak in (1.0, 2.0, 255.0):
        assert parity.psnr(x, y, peak) == jparity.psnr(x, y, peak)


@pytest.mark.parametrize("case,code", [("good", 0), ("bad", 1), ("shape", 2), ("npz", 0)])
def test_compare_matches_jax(tmp_path, capsys, case, code):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    np.save(tmp_path / "ref.npy", ref)
    ours = {"good": ref + 1e-4, "bad": ref + 0.5, "shape": np.zeros((3, 2), np.float32), "npz": ref + 1e-3}[case]
    if case == "npz":
        np.savez(tmp_path / "ours.npz", ours)
        path = str(tmp_path / "ours.npz")
    else:
        np.save(tmp_path / "ours.npy", ours)
        path = str(tmp_path / "ours.npy")
    assert parity.compare(str(tmp_path / "ref.npy"), path) == code
    port_out = capsys.readouterr().out
    assert jparity.compare(str(tmp_path / "ref.npy"), path) == code
    assert port_out == capsys.readouterr().out
    assert parity.main(["compare", str(tmp_path / "ref.npy"), path]) == code


def test_golden_without_diffusers(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusers", None)  # absent: importing it raises
    assert parity.main(["golden", "--pretrained_model_path", "nowhere"]) == 3
    assert "diffusers" in capsys.readouterr().out


def test_golden_defaults_to_the_card(monkeypatch):
    import types

    import torch

    fake = types.ModuleType("diffusers")
    fake.AutoencoderKL = None  # never reached: the device is resolved first
    monkeypatch.setitem(sys.modules, "diffusers", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parity.main(["golden", "--pretrained_model_path", "nowhere"])


@pytest.mark.parametrize("n,ncols", [(5, 2), (3, 4), (4, 4)])
def test_save_image_grid_matches_jax(tmp_path, n, ncols):
    from PIL import Image

    images = np.random.default_rng(n).integers(0, 256, (n, 6, 7, 3), dtype=np.uint8)
    got = save_image_grid(images, str(tmp_path / "port.png"), ncols=ncols)
    want = j_save_image_grid(images, str(tmp_path / "jax.png"), ncols=ncols)
    assert got == str(tmp_path / "port.png") and want == str(tmp_path / "jax.png")
    a, b = np.asarray(Image.open(got)), np.asarray(Image.open(want))
    np.testing.assert_array_equal(a, b)
    cols = min(ncols, n)
    assert a.shape == (-(-n // cols) * 6, cols * 7, 3)
