"""Image-to-video with Stable Video Diffusion (img2vid-xt), the port's
second model family, on the same serving path as ``I2VAdapterPipeline``.

A request is one condition image and no prompt (diffusers'
``StableVideoDiffusionPipeline``):

  1. the CLIP image token: the image resized to 224 with antialiasing
     (a Gaussian blur, then a bicubic resize), CLIP-normalised, through the
     ViT-H/14 tower and its projection; the unconditional half zeros
  2. the image latents: the image plus ``noise_aug_strength`` unit noise,
     VAE-encoded, the posterior mean unscaled; the unconditional half zeros
  3. the micro-conditions ``(fps - 1, motion_bucket_id, noise_aug_strength)``
  4. the EDM Euler loop (``schedulers.euler``): per step the CFG-doubled
     UNet on the scaled latents concatenated with the image latents, a
     guidance scale per frame from ``min`` to ``max``, the Euler update
  5. the temporal decode of ``latents / scaling_factor`` in chunks of
     ``decode_chunk_size`` frames, each chunk a clip of its own frames

The denoise loop replays its step from a CUDA graph (``StepGraphs``, kept
per shape for later calls) on the scan stream, as ``I2VAdapterPipeline``'s
``'scan'`` dispatch does; the CPU runs the same step eagerly.  The Euler
state, the latents between steps, stays in ``latents_dtype`` (fp32); the
models compute in ``dtype`` (bf16).  The random numbers come from one
device generator seeded with the request's seed: the augmentation noise,
then the initial latents.

A call is a ``request`` span with the I2V request's children: ``inputs``,
``prep`` (``image_encoder``, ``vae_encode``), ``denoise`` (``capture``,
``step`` per step), ``decode`` (a ``decode_chunk`` per chunk, with the
allocator's counters) and ``finish``; ``last_timings`` and
``last_dispatch`` are views of them (``span_views``).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from i2v_adapter_tpu_torch.config import SVDModelConfig, SVDPipelineConfig
from i2v_adapter_tpu_torch.device import DTYPES, DeviceLike, resolve_device
from i2v_adapter_tpu_torch.models.clip import CLIPVisionEncoder
from i2v_adapter_tpu_torch.models.svd import AutoencoderKLTemporalDecoder, SpatioTemporalUNet
from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import StepGraphs, _scan_stream, span_views
from i2v_adapter_tpu_torch.schedulers.euler import euler_sigmas, euler_step, init_noise_sigma, scale_model_input
from i2v_adapter_tpu_torch.utils import image as image_utils
from i2v_adapter_tpu_torch.utils import tracing

# the parts of a checkpoint directory written by ``save_pretrained``
PARTS = ("unet", "vae", "image_encoder")


def _gaussian_blur(x: torch.Tensor, size: int, sigma: float, dim: int) -> torch.Tensor:
    """Blur ``x (N, C, H, W)`` along ``dim`` (-1 or -2) with an odd
    ``size``-tap Gaussian, reflect padding."""
    taps = torch.arange(size, dtype=x.dtype, device=x.device) - size // 2
    k = torch.exp(-taps ** 2 / (2.0 * sigma ** 2))
    k = (k / k.sum()).view(1, 1, *((1, size) if dim == -1 else (size, 1)))
    pad = (size // 2, size // 2, 0, 0) if dim == -1 else (0, 0, size // 2, size // 2)
    c = x.shape[1]
    return F.conv2d(F.pad(x, pad, mode="reflect"), k.expand(c, 1, *k.shape[2:]), groups=c)


def resize_with_antialiasing(x: torch.Tensor, size: int) -> torch.Tensor:
    """SVD's image-encoder resize of ``x (N, C, H, W)`` to ``size`` x
    ``size``: a Gaussian blur of sigma ``max((factor - 1) / 2, 0.001)`` per
    axis over ``max(4 sigma, 3)`` taps (made odd), then a bicubic resize
    with aligned corners."""
    h, w = x.shape[-2:]
    for dim, factor in ((-1, w / size), (-2, h / size)):
        sigma = max((factor - 1.0) / 2.0, 0.001)
        taps = int(max(4.0 * sigma, 3))
        x = _gaussian_blur(x, taps + 1 - taps % 2, sigma, dim)
    return F.interpolate(x, size=(size, size), mode="bicubic", align_corners=True)


class StableVideoDiffusionPipeline:
    """Holds the UNet, the temporal VAE and the CLIP image tower.

    ``modules`` maps ``unet``, ``vae`` and ``image_encoder`` to built
    modules (``models.svd.SpatioTemporalUNet``,
    ``models.svd.AutoencoderKLTemporalDecoder``,
    ``models.clip.CLIPVisionEncoder``), moved to ``device`` in the
    configuration's dtype."""

    def __init__(self, model_config: SVDModelConfig, modules: Mapping[str, nn.Module],
                 pipeline_config: SVDPipelineConfig = SVDPipelineConfig(), device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config, self.pipe_config = model_config, pipeline_config
        self.dtype = DTYPES[pipeline_config.dtype]
        self.latents_dtype = DTYPES[pipeline_config.latents_dtype]
        self.unet = modules["unet"].to(self.device, self.dtype).eval()
        self.vae = modules["vae"].to(self.device, self.dtype).eval()
        self.image_encoder = modules["image_encoder"].to(self.device, self.dtype).eval()
        self.last_timings: dict = {}
        self.last_dispatch: dict = {}
        # the kept step graphs: one StepGraphs for the last request shape
        self._graphs: dict = {}

    @classmethod
    def from_pretrained(cls, path: str, model_config: Optional[SVDModelConfig] = None,
                        pipeline_config: SVDPipelineConfig = SVDPipelineConfig(), device: DeviceLike = None):
        """Load ``<path>/<part>/model.safetensors`` for each of ``PARTS``,
        in the port's parameter names, and the model configuration from
        ``<path>/model_config.json`` unless one is given (``save_pretrained``
        writes both)."""
        from i2v_adapter_tpu_torch.utils.safetensors_io import load_file

        dev = resolve_device(device)
        if model_config is None:
            with open(os.path.join(path, "model_config.json")) as f:
                model_config = SVDModelConfig.from_dict(json.load(f))
        built = {"unet": SpatioTemporalUNet(model_config.unet, device="meta"),
                 "vae": AutoencoderKLTemporalDecoder(model_config.vae, device="meta"),
                 "image_encoder": CLIPVisionEncoder(model_config.image_encoder, device="meta")}
        for part, module in built.items():
            tensors = {k: torch.from_numpy(v) for k, v in load_file(os.path.join(path, part, "model.safetensors")).items()}
            module.load_state_dict(tensors, strict=True, assign=True)
        return cls(model_config, built, pipeline_config, device=dev)

    def save_pretrained(self, path: str) -> None:
        """Write each part's parameters to ``<path>/<part>/model.safetensors``
        and the model configuration to ``<path>/model_config.json``."""
        from i2v_adapter_tpu_torch.utils.safetensors_io import save_file

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "model_config.json"), "w") as f:
            f.write(self.config.to_json())
        for part in PARTS:
            os.makedirs(os.path.join(path, part), exist_ok=True)
            module = getattr(self, part)
            save_file({k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()},
                      os.path.join(path, part, "model.safetensors"))

    def release_graphs(self) -> None:
        for loop in self._graphs.values():
            loop.close()
        self._graphs.clear()

    # ------------------------------------------------------------------

    def _image_token(self, image01: torch.Tensor) -> torch.Tensor:
        """The CLIP image token ``(1, 1, D)`` of ``image01 (1, H, W, 3)`` in
        [0, 1]."""
        size = self.config.image_encoder.image_size
        x = resize_with_antialiasing(image01.permute(0, 3, 1, 2) * 2.0 - 1.0, size)
        x = ((x + 1.0) / 2.0).permute(0, 2, 3, 1)
        mean = torch.as_tensor(image_utils.CLIP_MEAN, device=x.device)
        std = torch.as_tensor(image_utils.CLIP_STD, device=x.device)
        return self.image_encoder((x - mean) / std, dtype=self.dtype)[:, None]

    def _step_fn(self, sigmas: torch.Tensor, c_noise: torch.Tensor):
        """``step(consts, latents, t, tp, eta_noise=None)``: the Euler step
        from ``sigmas[t]`` to ``sigmas[tp]`` (``t``, ``tp`` step indices:
        host ints or 0-d device tensors, so a captured step reads them)."""
        unet, dtype = self.unet, self.dtype

        def at(table, i):
            # a (1,) index: a 0-d device index would be read on the host, which a capture refuses
            return table[torch.as_tensor(i, device=table.device).reshape(1)]

        def step(consts, latents, t, tp, generator=None, *, eta_noise=None):
            embeds, image_latents, time_ids, guidance = consts
            sigma, sigma_next = at(sigmas, t), at(sigmas, tp)
            x = scale_model_input(latents, sigma).to(dtype)
            x = torch.cat([torch.cat([x, x]), image_latents.expand(-1, x.shape[1], -1, -1, -1)], dim=-1)
            uncond, cond = unet(x, at(c_noise, t), embeds, time_ids).float().chunk(2)
            v = torch.lerp(uncond, cond, guidance)
            return euler_step(v, latents, sigma, sigma_next).to(latents.dtype)

        return step

    def _denoise(self, key: tuple, step, consts, latents: torch.Tensor, steps: int) -> torch.Tensor:
        """The ``denoise`` span: ``steps`` Euler steps from ``StepGraphs``
        kept under ``key``, on the scan stream of the card."""
        cuda = self.device.type == "cuda"
        with tracing.span("denoise") as span:
            loop = self._graphs.pop(key, None)
            hit = loop is not None
            self.release_graphs()  # one kept shape: its pool is the card's largest allocation
            if not hit:
                loop = StepGraphs((None, step, None, None, None, (None, None, None)), consts, latents)
            side = _scan_stream(self.device) if cuda else None
            if cuda:
                side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                if hit:
                    loop.load(consts, latents)
                for i in range(steps):
                    with tracing.span("step", device_ms=cuda):
                        loop.step("cfg", i, i + 1)
            if cuda:
                torch.cuda.current_stream(self.device).wait_stream(side)
                side.synchronize()
            self._graphs[key] = loop
            span.attrs.update(graph_pool_bytes=loop.pool_bytes, graph_cache={"hit": hit})
            return loop.latents.clone()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def __call__(self, image, num_frames: Optional[int] = None, height: Optional[int] = None,
                 width: Optional[int] = None, num_inference_steps: Optional[int] = None,
                 min_guidance_scale: Optional[float] = None, max_guidance_scale: Optional[float] = None,
                 fps: Optional[int] = None, motion_bucket_id: Optional[int] = None,
                 noise_aug_strength: Optional[float] = None, decode_chunk_size: Optional[int] = None,
                 seed: int = 0, output_type: str = "np"):
        """One clip from ``image`` (a PIL image or an ``(H, W, 3)`` array,
        uint8 or float in [0, 1]; the CLIP token is taken from it as given,
        the latents from it resized to ``height`` x ``width``): ``(1, F, H, W, 3)`` uint8 (``'np'``),
        float32 in [-1, 1] (``'pt'``), or the final latents ``(1, F, h, w,
        4)`` (``'latent'``, not divided by ``scaling_factor``).  Every other
        argument defaults to the pipeline config's."""
        pc = self.pipe_config
        with tracing.span("request") as request:
            with tracing.span("inputs"):
                if output_type not in ("np", "pt", "latent"):
                    raise ValueError(f"output_type must be 'np', 'pt' or 'latent', got {output_type!r}")
                frames = num_frames or pc.num_frames
                height, width = height or pc.height, width or pc.width
                steps = num_inference_steps or pc.num_inference_steps
                lo = pc.min_guidance_scale if min_guidance_scale is None else min_guidance_scale
                hi = pc.max_guidance_scale if max_guidance_scale is None else max_guidance_scale
                fps = pc.fps if fps is None else fps
                motion = pc.motion_bucket_id if motion_bucket_id is None else motion_bucket_id
                aug = pc.noise_aug_strength if noise_aug_strength is None else noise_aug_strength
                chunk = decode_chunk_size or pc.decode_chunk_size
                sf = self.config.vae.spatial_scale_factor
                if height % sf or width % sf:
                    raise ValueError(f"height and width must be multiples of {sf}, got {height}x{width}")
                if hi <= 1.0:
                    raise ValueError("the pipeline runs classifier-free guidance: max_guidance_scale must exceed 1")
                dev = self.device
                source = image_utils._to_numpy(image)[..., :3]
                image01 = torch.as_tensor(source, device=dev)[None]
                if source.shape[:2] != (height, width):
                    source = image_utils._resize_bilinear(source, height, width)
                pixels = torch.as_tensor(source, device=dev)[None] * 2.0 - 1.0
                sigmas, c_noise = euler_sigmas(self.config.scheduler, steps, dev)
                time_ids = torch.tensor([[fps - 1, motion, aug]], dtype=torch.float32, device=dev).repeat(2, 1)
                guidance = torch.linspace(lo, hi, frames, device=dev).view(1, frames, 1, 1, 1)
                gen = torch.Generator(device=dev).manual_seed(int(seed))
                lh, lw = height // sf, width // sf
                self._sync()
            with tracing.span("prep"):
                with tracing.span("image_encoder"):
                    token = self._image_token(image01)
                    embeds = torch.cat([torch.zeros_like(token), token])
                with tracing.span("vae_encode"):
                    noise = torch.randn(pixels.shape, generator=gen, device=dev)
                    cond = self.vae.encode_mean((pixels + aug * noise).to(self.dtype))
                    image_latents = torch.cat([torch.zeros_like(cond), cond])[:, None]
                shape = (1, frames, lh, lw, self.config.unet.out_channels)
                latents = torch.randn(shape, generator=gen, device=dev) * init_noise_sigma(sigmas)
                latents = latents.to(self.latents_dtype)
                self._sync()
            key = (frames, height, width, steps, float(lo), float(hi))
            consts = (embeds, image_latents, time_ids, guidance)
            latents = self._denoise(key, self._step_fn(sigmas, c_noise), consts, latents, steps)
            out = latents
            if output_type != "latent":
                with tracing.span("decode", counters=("alloc",)):
                    z = (latents.reshape(frames, lh, lw, -1) / self.config.vae.scaling_factor).to(self.dtype)
                    video = []
                    for i in range(0, frames, chunk):
                        with tracing.span("decode_chunk", counters=("alloc",)):
                            part = z[i:i + chunk]
                            video.append(self.vae.decode(part, part.shape[0]))
                    out = torch.cat(video).reshape(1, frames, height, width, -1)
                    self._sync()
            with tracing.span("finish"):
                out = out.float().cpu().numpy()
                if not np.isfinite(out).all():
                    raise FloatingPointError("generated video contains non-finite values")
                out = image_utils.postprocess_video(out) if output_type == "np" else out
        self.last_timings, self.last_dispatch = span_views(request)
        return out
