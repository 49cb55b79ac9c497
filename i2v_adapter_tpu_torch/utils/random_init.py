"""Seeded random weights for runs without a checkpoint (smoke runs and
profiles at full width): fan-in scaled so activations stay O(1)."""

from __future__ import annotations

import math
import tempfile

import torch


def randomize_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """In place: matrices N(0, 1/fan_in), norm scales 1 + 0.1 N, other
    vectors 0.1 N, drawn on the module's device."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.normal_(generator=g)
            if p.ndim >= 2:
                p.div_(math.sqrt(p[0].numel()))
            elif name.endswith("weight"):
                p.mul_(0.1).add_(1.0)
            else:
                p.mul_(0.1)
    return module


def random_pipeline(model_cfg, pipe_cfg, device, seed: int = 1, unet=None):
    """An I2VAdapterPipeline on ``device`` with seeded random weights and a
    miniature tokenizer padded to the text encoder's context length."""
    from i2v_adapter_tpu_torch.models import (
        AutoencoderKL,
        CLIPTextEncoder,
        CLIPVisionEncoder,
        VideoUNet,
    )
    from i2v_adapter_tpu_torch.pipelines import I2VAdapterPipeline
    from i2v_adapter_tpu_torch.utils.tokenizer import make_test_tokenizer

    modules = {
        "unet": unet if unet is not None else randomize_(VideoUNet(model_cfg.unet, device=device), seed),
        "vae": randomize_(AutoencoderKL(model_cfg.vae, device=device), seed + 2),
        "text_encoder": randomize_(CLIPTextEncoder(model_cfg.text_encoder, device=device), seed + 3),
        "image_encoder": randomize_(CLIPVisionEncoder(model_cfg.image_encoder, device=device), seed + 4),
    }
    with tempfile.TemporaryDirectory() as tmp:
        tok = make_test_tokenizer(tmp)
    tok.context_length = model_cfg.text_encoder.max_position_embeddings
    return I2VAdapterPipeline(model_cfg, modules, tok, pipe_cfg, device=device)


def random_train_state(model_cfg, train_cfg, device, seed: int = 1, total_steps: int = 1000, mesh=None,
                       shardings=None):
    """A ``TrainState`` on ``device`` with seeded random weights at the
    configuration's widths (UNet, VAE, CLIP text and, with the IP-Adapter,
    CLIP vision); placed over ``mesh`` by ``shardings`` when given
    (``create_train_state``)."""
    from i2v_adapter_tpu_torch.models import (
        AutoencoderKL,
        CLIPTextEncoder,
        CLIPVisionEncoder,
        VideoUNet,
    )
    from i2v_adapter_tpu_torch.training import create_train_state

    image = (randomize_(CLIPVisionEncoder(model_cfg.image_encoder, device=device), seed + 4)
             if model_cfg.unet.use_ip_adapter else None)
    return create_train_state(
        randomize_(VideoUNet(model_cfg.unet, device=device), seed), train_cfg, total_steps,
        vae=randomize_(AutoencoderKL(model_cfg.vae, device=device), seed + 2),
        text_encoder=randomize_(CLIPTextEncoder(model_cfg.text_encoder, device=device), seed + 3),
        image_encoder=image, mesh=mesh, shardings=shardings,
    )


def random_train_batch(model_cfg, train_cfg, device, seed: int = 0) -> dict:
    """A synthetic batch at ``train_cfg``'s batch size, frames and
    resolution: pixels uniform in [-1, 1], random token ids, a random CLIP
    image."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, f, r = train_cfg.train_batch_size, train_cfg.num_frames, train_cfg.resolution
    n_ctx, vocab = model_cfg.text_encoder.max_position_embeddings, model_cfg.text_encoder.vocab_size
    s = model_cfg.image_encoder.image_size
    return {
        "pixel_values": torch.rand((b, f, r, r, 3), generator=g, device=device) * 2 - 1,
        "text_ids": torch.randint(0, vocab, (b, n_ctx), generator=g, device=device),
        "uncond_ids": torch.zeros((b, n_ctx), dtype=torch.long, device=device),
        "clip_image": torch.randn((b, s, s, 3), generator=g, device=device),
    }
