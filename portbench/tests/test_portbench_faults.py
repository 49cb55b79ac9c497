"""A run with the timed path broken underneath must read ``correct``
false: each fault a cell can have, planted in the program, at the tiny
sizes on the CPU (the exchange between chips is absent: every cell takes
one chip)."""

import pytest
import torch

from portbench.tests.common import run_in_process

SERVE, TRAIN = "serve256_clip", "train256_b8"


def test_sound_runs_are_correct(capsys):
    for cell in (SERVE, TRAIN):
        assert run_in_process(cell, capsys)["correct"] is True


def _serve_unchanged(mp):
    from i2v_adapter_tpu_torch.pipelines import i2v_pipeline

    mp.setattr(i2v_pipeline, "ddim_step", lambda sched, out, t, tp, sample, **kw: sample)


def _serve_half_batch(mp):
    from i2v_adapter_tpu_torch.models import VideoUNet

    orig = VideoUNet.forward

    def half(self, sample, t, enc, img=None, **kw):
        n = sample.shape[0] // 2
        if torch.is_tensor(t) and t.ndim and t.shape[0] == sample.shape[0]:
            t = t[n:]
        out = orig(self, sample[n:], t, enc[n:], None if img is None else img[n:], **kw)
        return torch.cat([out, out])

    mp.setattr(VideoUNet, "forward", half)


def _serve_altered(mp):
    from i2v_adapter_tpu_torch.utils import image

    orig = image.postprocess_video

    def altered(video):
        out = orig(video)
        out[:, -1] = 255 - out[:, -1]
        return out

    mp.setattr(image, "postprocess_video", altered)


def _train_unchanged(mp):
    from i2v_adapter_tpu_torch.training.state import Optimizer

    mp.setattr(Optimizer, "update", lambda self, grads, state, params, norm=None:
               {n: torch.zeros_like(g) for n, g in grads.items()})


def _train_half_batch(mp):
    from i2v_adapter_tpu_torch.training import train_i2v

    orig = train_i2v.diffusion_loss
    mp.setattr(train_i2v, "diffusion_loss", lambda pred, target, t, *a, **k:
               orig(pred[: len(pred) // 2], target[: len(pred) // 2], t[: len(pred) // 2], *a, **k))


def _train_altered(mp):
    from i2v_adapter_tpu_torch.training import train_i2v

    orig = train_i2v.diffusion_loss
    mp.setattr(train_i2v, "diffusion_loss", lambda *a, **k: orig(*a, **k) * 1.05)


@pytest.mark.parametrize("cell,plant", [
    (SERVE, _serve_unchanged), (SERVE, _serve_half_batch), (SERVE, _serve_altered),
    (TRAIN, _train_unchanged), (TRAIN, _train_half_batch), (TRAIN, _train_altered),
], ids=["serve-step-unchanged", "serve-half-batch", "serve-frame-altered",
        "train-state-unchanged", "train-half-batch", "train-loss-altered"])
def test_fault_reads_incorrect(cell, plant, monkeypatch, capsys):
    plant(monkeypatch)
    line = run_in_process(cell, capsys)
    assert line["correct"] is False, line["checks"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
