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
(prep, step, decode); ``__call__`` drives them eagerly on the device, one
step at a time (the JAX package's ``dispatch='stepwise'``).
``from_pretrained`` assembles the pipeline from a diffusers-layout
checkpoint directory through the key maps of ``utils.convert``.

The serving default, ``PipelineConfig.int8_conv=True``, runs the UNet's
resnet / down / upsample 3x3 convs and the VAE decoder's convs in int8
(``ops.int8``); ``enable_int8_conv(False)`` restores exact convs on the
same weights.  Not ported yet (ROADMAP): meshes, ``dispatch='scan'``,
``encoder_cache`` and ``cfg_cutoff`` (refused unless off), temporal tiling,
``unet_chunk``, sliced/tiled decode.
"""

from __future__ import annotations

import glob
import os
import time
from typing import List, Mapping, Optional, Sequence, Union

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
from i2v_adapter_tpu_torch.utils import convert
from i2v_adapter_tpu_torch.utils import image as image_utils
from i2v_adapter_tpu_torch.utils.convert import load_flax_params
from i2v_adapter_tpu_torch.utils.tokenizer import CLIPTokenizer


def _refuse_unported(encoder_cache, cfg_cutoff) -> None:
    """Refuse the serving approximations that are not ported yet: any
    ``encoder_cache`` but 1 and any ``cfg_cutoff`` but 1.0 (both off)."""
    unported = []
    if encoder_cache != 1:
        unported.append(f"encoder_cache={encoder_cache} (only 1, off)")
    if cfg_cutoff != 1.0:
        unported.append(f"cfg_cutoff={cfg_cutoff} (only 1.0, off)")
    if unported:
        raise NotImplementedError("not ported yet (ROADMAP: serving extras): " + "; ".join(unported))


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
        _refuse_unported(pipeline_config.encoder_cache, pipeline_config.cfg_cutoff)
        if pipeline_config.int8_conv:
            # serving default: int8 UNet / VAE-decoder convs on the same weights
            model_config = model_config.replace(
                unet=model_config.unet.replace(int8_conv=True),
                vae=model_config.vae.replace(int8_decode=True),
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

    @classmethod
    def from_pretrained(
        cls,
        path: str,
        model_config: Optional[I2VModelConfig] = None,
        pipeline_config: PipelineConfig = PipelineConfig(),
        i2v_adapter_path: Optional[str] = None,
        motion_adapter_path: Optional[str] = None,
        ip_adapter_path: Optional[str] = None,
        device: DeviceLike = None,
    ) -> "I2VAdapterPipeline":
        """Assemble from torch-layout checkpoints on disk.  ``path`` uses the
        diffusers directory layout: ``unet/``, ``vae/``, ``text_encoder/``,
        ``tokenizer/``, with the IP-Adapter ``image_encoder/``; the motion
        adapter, the I2V adapter and the IP-Adapter default to the sibling
        folders ``motion_adapter/``, ``i2v_adapter/`` and ``ip_adapter/``
        (the first ``.safetensors`` of a folder, else its first ``.bin``).
        Without an I2V-adapter checkpoint the adapter is the zero-init no-op.
        The IP-Adapter's head variant is read from its keys; the plus and
        full_face heads are refused by the UNet (not ported yet).

        Each model is converted, loaded into its module on ``device`` and
        cast to the pipeline's dtype before the next file is read, so the
        host holds one model's arrays at a time (every float leaf, fp16
        included, is stored in the compute dtype)."""
        model_config = model_config or I2VModelConfig()
        device = resolve_device(device)
        dtype = DTYPES[pipeline_config.dtype]

        def find_weights(sub):
            for pattern in ("*.safetensors", "*.bin"):
                hits = sorted(glob.glob(os.path.join(path, sub, pattern)))
                if hits:
                    return hits[0]
            return None

        def load(sub, given=None, required=False):
            found = given or find_weights(sub)
            if found is None and required:
                raise FileNotFoundError(f"no weights in {os.path.join(path, sub)} (*.safetensors or *.bin)")
            return convert.load_state_dict(found) if found else None

        def build(module, tree):
            return load_flax_params(module, tree).to(device, dtype).eval()

        ip_sd = load("ip_adapter", ip_adapter_path)
        if ip_sd is not None and model_config.unet.use_ip_adapter:
            model_config = model_config.replace(
                unet=model_config.unet.replace(**convert.ip_config_updates(ip_sd)))
        unet = VideoUNet(model_config.unet, device=device)  # refuses an unported IP head first
        tree = convert.convert_unet(
            load("unet", required=True), model_config.unet, load("motion_adapter", motion_adapter_path),
            load("i2v_adapter", i2v_adapter_path), ip_sd)
        del ip_sd
        modules = {"unet": build(unet, tree)}
        del tree, unet
        mc = model_config
        modules["vae"] = build(AutoencoderKL(mc.vae, device=device),
                               convert.convert_vae(load("vae", required=True), mc.vae))
        modules["text_encoder"] = build(
            CLIPTextEncoder(mc.text_encoder, device=device),
            convert.convert_clip_text(load("text_encoder", required=True), mc.text_encoder))
        if mc.unet.use_ip_adapter:
            modules["image_encoder"] = build(
                CLIPVisionEncoder(mc.image_encoder, device=device),
                convert.convert_clip_vision(load("image_encoder", required=True), mc.image_encoder))
        tokenizer = CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer"))
        return cls(model_config, modules, tokenizer, pipeline_config, device=device)

    def export_gifs(self, video_uint8: np.ndarray, prefix: str, fps: int = 8) -> List[str]:
        """One GIF per clip of a (B, F, H, W, 3) uint8 video:
        ``<prefix>_<i>.gif``."""
        return [image_utils.export_to_gif(clip, f"{prefix}_{i}.gif", fps)
                for i, clip in enumerate(video_uint8)]

    def _module(self, value, cls, cfg) -> nn.Module:
        if not isinstance(value, nn.Module):
            value = load_flax_params(cls(cfg, device=self.device), value)
        elif hasattr(value, "set_int8"):
            value.set_int8(cfg.int8_conv if cls is VideoUNet else cfg.int8_decode)
        return value.to(self.device, self.dtype).eval()

    def enable_int8_conv(self, enabled: bool = True) -> None:
        """Serving-mode int8 convs: the UNet's resnet / down / upsample 3x3s
        (``VideoUNetConfig.int8_conv``) and the VAE decoder's convs
        (``VAEConfig.int8_decode``).  On by default
        (``PipelineConfig.int8_conv``); ``False`` restores exact convs.  The
        weights are unchanged, so nothing is reloaded."""
        self.config = self.config.replace(
            unet=self.config.unet.replace(int8_conv=enabled),
            vae=self.config.vae.replace(int8_decode=enabled),
        )
        self.unet.set_int8(enabled)
        self.vae.set_int8(enabled)

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
        ``step_fn(consts, latents, t, t_prev, generator=None, *,
            eta_noise=None) -> latents``: first-frame clamp, CFG-doubled
            UNet, guidance, DDIM update (with ``eta > 0`` the noise is
            ``eta_noise`` when given, else drawn from the generator).
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

        def step_fn(consts, latents, t, tp, generator=None, *, eta_noise=None):
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
            if pcfg.eta <= 0.0:
                eta_noise = None
            elif eta_noise is None:
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
        dispatch: str = "auto",
        encoder_cache: Optional[int] = None,
        cfg_cutoff: Optional[float] = None,
    ):
        """Generate clips: (B, F, H, W, 3) uint8 (``output_type='np'``),
        float32 in [-1, 1] (``'pt'`` or ``'float'``), or the final latents
        without a decode (``'latent'``: (B, F, h, w, 4) float32, the first
        frame clamped to the condition, still times ``scaling_factor``).
        Phase times of the call (ms, synchronised on the GPU) are left in
        ``self.last_timings``; ``'latent'`` has no ``decode_ms``.

        ``dispatch``: ``'auto'`` and ``'stepwise'`` run the eager loop, one
        device pass per denoise step (the JAX package's stepwise dispatch);
        ``'scan'``, the whole clip as one fused dispatch, is not ported yet
        (CUDA-graph capture) and raises ``NotImplementedError``.
        ``encoder_cache`` / ``cfg_cutoff`` (None: the pipeline config's):
        values outside the reference's domain raise ``ValueError``, as
        there; any value but off (1, 1.0) raises ``NotImplementedError``."""
        if output_type not in ("np", "pt", "float", "latent"):
            raise ValueError(f"output_type must be 'np', 'pt', 'float' or 'latent', got {output_type!r}")
        if dispatch not in ("auto", "scan", "stepwise"):
            raise ValueError(f"dispatch must be auto/scan/stepwise, got {dispatch!r}")
        if dispatch == "scan":
            raise NotImplementedError(
                "dispatch='scan' (the whole clip as one fused dispatch) is not ported yet "
                "(ROADMAP: serving extras, CUDA-graph capture); 'auto' and 'stepwise' run")
        pcfg = self.pipe_config
        encoder_cache = pcfg.encoder_cache if encoder_cache is None else encoder_cache
        cfg_cutoff = pcfg.cfg_cutoff if cfg_cutoff is None else cfg_cutoff
        if encoder_cache not in (1, 2):
            raise ValueError(f"encoder_cache must be 1 (off) or 2, got {encoder_cache}")
        if not 0.0 <= cfg_cutoff <= 1.0:
            raise ValueError(f"cfg_cutoff must be in [0, 1], got {cfg_cutoff}")
        _refuse_unported(encoder_cache, cfg_cutoff)
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
        if output_type == "latent":
            if has_condition:
                latents = latents.clone()
                latents[:, 0] = consts[0].to(latents.dtype)
            out, what = latents.float().cpu().numpy(), "latents"
        else:
            video = decode_fn(consts, latents)
            self.last_timings["decode_ms"] = (self._sync() - t1) * 1e3
            out, what = video.cpu().numpy(), "video"
        if not np.isfinite(out).all():
            raise FloatingPointError(
                f"generated {what} contain non-finite values; with the static-offset "
                "flash softmax retry with VideoUNetConfig.flash_static_max=0.0"
            )
        if output_type == "np":
            return image_utils.postprocess_video(out)
        return out
