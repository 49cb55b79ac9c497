"""Image-to-video inference pipeline (PyTorch port).

Counterpart of the JAX ``I2VAdapterPipeline``:

  1. CLIP-encode the prompt (+ negative) and the IP-Adapter image
  2. VAE-encode the condition image
  3. PIA similarity prior: blurred and sharp condition latents mixed by a
     per-element Bernoulli mask, noised to the first kept timestep
  4. DDIM loop with classifier-free guidance, the first-frame latent
     clamped to the condition every step
  5. final clamp and VAE decode of all frames

``_build_parts`` returns the same three functions as the JAX package's
(prep, step, decode); ``__call__`` drives them eagerly on the device.
Not ported yet (ROADMAP): ``from_pretrained``, meshes, ``encoder_cache``,
``cfg_cutoff``, temporal tiling, ``unet_chunk``, sliced/tiled decode, GIF
export and int8 serving convs.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from i2v_adapter_tpu_torch.config import I2VModelConfig, PipelineConfig
from i2v_adapter_tpu_torch.device import DTYPES, DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextEncoder,
    CLIPVisionEncoder,
    VideoUNet,
)
from i2v_adapter_tpu_torch.ops.blur import gaussian_blur
from i2v_adapter_tpu_torch.schedulers import add_noise, ddim_schedule_arrays, ddim_step, make_schedule
from i2v_adapter_tpu_torch.utils import image as image_utils
from i2v_adapter_tpu_torch.utils.convert import load_flax_params
from i2v_adapter_tpu_torch.utils.tokenizer import CLIPTokenizer


class I2VAdapterPipeline:
    """Holds the four models, the tokenizer and the schedule.

    ``modules`` maps ``unet``, ``vae``, ``text_encoder`` and (with the
    IP-Adapter) ``image_encoder`` to either a built ``nn.Module`` or a Flax
    param tree of the JAX package, which is loaded into a new module."""

    def __init__(
        self,
        model_config: I2VModelConfig,
        modules: Mapping[str, object],
        tokenizer: CLIPTokenizer,
        pipeline_config: PipelineConfig = PipelineConfig(),
        device: DeviceLike = None,
    ):
        if pipeline_config.int8_conv:
            raise NotImplementedError(
                "PipelineConfig.int8_conv=True is not ported yet (ROADMAP: int8 "
                "serving convs); pass PipelineConfig(int8_conv=False) for exact convs"
            )
        self.device = resolve_device(device)
        self.dtype = DTYPES[pipeline_config.dtype]
        self.config = model_config
        self.pipe_config = pipeline_config
        self.tokenizer = tokenizer
        self.unet = self._module(modules["unet"], VideoUNet, model_config.unet)
        self.vae = self._module(modules["vae"], AutoencoderKL, model_config.vae)
        self.text_encoder = self._module(
            modules["text_encoder"], CLIPTextEncoder, model_config.text_encoder
        )
        self.image_encoder = (
            self._module(modules["image_encoder"], CLIPVisionEncoder, model_config.image_encoder)
            if model_config.unet.use_ip_adapter else None
        )
        self.schedule = make_schedule(model_config.scheduler)
        self.last_timings: dict = {}

    def _module(self, value, cls, cfg) -> nn.Module:
        if not isinstance(value, nn.Module):
            value = load_flax_params(cls(cfg, device=self.device), value)
        return value.to(self.device, self.dtype).eval()

    # ------------------------------------------------------------------
    # the three parts
    # ------------------------------------------------------------------

    def _build_parts(
        self,
        batch: int,
        num_frames: int,
        height: int,
        width: int,
        num_inference_steps: int,
        strength: float,
        guidance_scale: float,
        use_cfg: bool,
        has_condition: bool,
    ):
        """(prep_fn, step_fn, decode_fn, timesteps, prev_timesteps).

        ``prep_fn(text_ids, cond_image, clip_image, generator, ...)
            -> (latents, consts)`` with consts = (cond_latents, text_states,
            image_embeds); the posterior noise, the prior's mask draw and
            noise come from ``generator`` unless passed in.
        ``step_fn(consts, latents, t, t_prev, generator=None) -> latents``:
            first-frame clamp, CFG-doubled UNet, guidance, DDIM update (the
            generator draws the eta noise when ``eta > 0``).
        ``decode_fn(consts, latents) -> (B, F, H, W, 3)`` float video."""
        cfg, pcfg = self.config, self.pipe_config
        dev, dtype, schedule = self.device, self.dtype, self.schedule
        scale = cfg.vae.scaling_factor
        f = num_frames
        sf = cfg.vae.spatial_scale_factor
        lh, lw = height // sf, width // sf
        ts, prev = ddim_schedule_arrays(
            cfg.scheduler, num_inference_steps, strength if has_condition else 1.0
        )
        prior_shape = (batch, f, lh, lw, cfg.unet.in_channels)

        def prep_fn(text_ids, cond_image, clip_image, generator=None, *,
                    posterior_noise=None, mask_uniform=None, prior_noise=None):
            text_states = self.text_encoder(torch.as_tensor(text_ids, device=dev))
            image_embeds = None
            if cfg.unet.use_ip_adapter:
                image_embeds = self.image_encoder(torch.as_tensor(clip_image, device=dev))
                if use_cfg:
                    image_embeds = torch.cat([torch.zeros_like(image_embeds), image_embeds])
            if not has_condition:
                latents = torch.randn(prior_shape, generator=generator, device=dev)
                return latents, (None, text_states, image_embeds)
            cond = torch.as_tensor(cond_image, device=dev).to(dtype)
            if posterior_noise is None and generator is None:
                raise ValueError("prep_fn needs a generator or the posterior noise")
            cond_latents = self.vae.encode(cond, noise=posterior_noise, generator=generator) * scale
            sigma = pcfg.blur_sigma
            if sigma is None:
                sigma = float(torch.rand((), generator=generator, device=dev)) * 1.9 + 0.1
            blurred = gaussian_blur(cond_latents, pcfg.blur_kernel_size, sigma)
            if mask_uniform is None:
                mask_uniform = torch.rand(prior_shape, generator=generator, device=dev)
            mask = (mask_uniform < pcfg.frame_similarity_blurred_strength).to(cond_latents.dtype)
            prior = mask * blurred[:, None] + (1 - mask) * cond_latents[:, None]
            if prior_noise is None:
                prior_noise = torch.randn(prior_shape, generator=generator, device=dev)
            latents = add_noise(
                schedule, prior.float(), prior_noise.float(), torch.full((batch,), int(ts[0]))
            )
            return latents, (cond_latents, text_states, image_embeds)

        def step_fn(consts, latents, t, tp, generator=None):
            cond_latents, text_states, image_embeds = consts
            if has_condition:
                latents = latents.clone()
                latents[:, 0] = cond_latents.to(latents.dtype)
            model_in = torch.cat([latents, latents]) if use_cfg else latents
            noise_pred = self.unet(
                model_in.to(dtype), torch.full((model_in.shape[0],), float(t), device=dev),
                text_states, image_embeds, enable_cross_frame_attn=has_condition,
            ).float()
            if use_cfg:
                uncond, text = noise_pred.chunk(2)
                noise_pred = uncond + guidance_scale * (text - uncond)
            eta_noise = None
            if pcfg.eta > 0.0:
                eta_noise = torch.randn(latents.shape, generator=generator, device=dev)
            return ddim_step(
                schedule, noise_pred, torch.full((batch,), int(t)),
                torch.full((batch,), int(tp)), latents, eta=pcfg.eta, noise=eta_noise,
            )

        def decode_fn(consts, latents):
            if has_condition:
                latents = latents.clone()
                latents[:, 0] = consts[0].to(latents.dtype)
            flat = latents.reshape(batch * f, lh, lw, cfg.unet.in_channels)
            video = self.vae.decode((flat / scale).to(dtype))
            return video.reshape(batch, f, height, width, cfg.vae.out_channels).float()

        return prep_fn, step_fn, decode_fn, ts, prev

    # ------------------------------------------------------------------
    # user entry point
    # ------------------------------------------------------------------

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Union[str, Sequence[str]],
        condition_image=None,
        ip_adapter_image=None,
        negative_prompt: Union[str, Sequence[str], None] = None,
        num_frames: Optional[int] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        frame_similarity_sample_ratio: Optional[float] = None,
        seed: int = 0,
        output_type: str = "np",
    ):
        """Generate clips: (B, F, H, W, 3) uint8 (``output_type='np'``) or
        float32 in [-1, 1] (``'float'``).  Phase times of the call (ms,
        synchronised on the GPU) are left in ``self.last_timings``."""
        pcfg = self.pipe_config
        num_frames = num_frames or pcfg.num_frames
        height = height or pcfg.height
        width = width or pcfg.width
        steps = num_inference_steps or pcfg.num_inference_steps
        guidance = guidance_scale if guidance_scale is not None else pcfg.guidance_scale
        strength = (
            frame_similarity_sample_ratio if frame_similarity_sample_ratio is not None
            else pcfg.frame_similarity_sample_ratio
        )
        if num_frames > self.config.unet.motion_max_seq_length:
            raise NotImplementedError(
                "clips longer than motion_max_seq_length need temporal tiling, "
                "not ported yet (ROADMAP: serving extras)"
            )
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        batch = len(prompts)
        use_cfg = guidance > 1.0
        has_condition = condition_image is not None
        if negative_prompt is None:
            negatives = [""] * batch
        elif isinstance(negative_prompt, str):
            negatives = [negative_prompt] * batch
        else:
            negatives = list(negative_prompt)
        text_ids = self.tokenizer(negatives + prompts if use_cfg else prompts, padding="max_length")

        if has_condition:
            cond = image_utils.preprocess_batch(condition_image, height, width)
            if cond.shape[0] != batch and batch % cond.shape[0] == 0:
                cond = np.repeat(cond, batch // cond.shape[0], axis=0)
        else:
            cond = np.zeros((batch, height, width, 3), dtype=np.float32)
        ip_source = ip_adapter_image if ip_adapter_image is not None else condition_image
        size = self.config.image_encoder.image_size
        if self.config.unet.use_ip_adapter and ip_source is not None:
            srcs = ip_source if isinstance(ip_source, (list, tuple)) else [ip_source]
            clip_img = np.stack([image_utils.clip_preprocess(s, size) for s in srcs])
            if clip_img.shape[0] != batch and batch % clip_img.shape[0] == 0:
                clip_img = np.repeat(clip_img, batch // clip_img.shape[0], axis=0)
        else:
            clip_img = np.zeros((batch, size, size, 3), dtype=np.float32)

        prep_fn, step_fn, decode_fn, ts, prev = self._build_parts(
            batch, num_frames, height, width, steps, float(strength), float(guidance),
            use_cfg, has_condition,
        )
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        t0 = self._sync()
        latents, consts = prep_fn(text_ids, cond, clip_img, gen)
        t1 = self._sync()
        self.last_timings = {"prep_ms": (t1 - t0) * 1e3, "step_ms": []}
        for t, tp in zip(ts, prev):
            latents = step_fn(consts, latents, t, tp, generator=gen)
            t2 = self._sync()
            self.last_timings["step_ms"].append((t2 - t1) * 1e3)
            t1 = t2
        video = decode_fn(consts, latents)
        self.last_timings["decode_ms"] = (self._sync() - t1) * 1e3
        video = video.cpu().numpy()
        if not np.isfinite(video).all():
            raise FloatingPointError(
                "generated video contains non-finite values; with the static-offset "
                "flash softmax retry with VideoUNetConfig.flash_static_max=0.0"
            )
        if output_type == "float":
            return video
        return image_utils.postprocess_video(video)
