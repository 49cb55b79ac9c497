"""Image-to-video inference pipeline (PyTorch port).

Counterpart of the JAX ``I2VAdapterPipeline``:

  1. CLIP-encode the prompt (+ negative) and the IP-Adapter image
  2. VAE-encode the condition image
  3. PIA similarity prior: blurred and sharp condition latents mixed by a
     per-element Bernoulli mask, noised to the first kept timestep
  4. DDIM loop with classifier-free guidance, the first-frame latent
     clamped to the condition every step
  5. final clamp and VAE decode of all frames

``_build_parts`` returns the same functions as the JAX package's (prep,
step, decode, and the encoder-cache step pair and the cond-only step of the
two opt-in serving approximations); ``__call__`` drives the denoise loop
either eagerly, one step at a time (``dispatch='stepwise'``), or from
static buffers with each step kind replayed from a CUDA graph
(``dispatch='scan'``, ``StepGraphs``: the counterpart of the JAX package's
one fused ``lax.scan`` program, kept per shape bucket across calls as the
JAX package keeps its compiled samplers in ``_sampler_cache``); ``'auto'``
picks as the JAX package does.
Clips longer than the motion modules' cap are denoised in anchored
temporal windows (``pipelines.tiling``), the UNet can run the CFG-doubled
batch in chunks (``unet_chunk``), and the decode can be sliced or tiled.
``from_pretrained`` assembles the pipeline from a diffusers-layout
checkpoint directory through the key maps of ``utils.convert``.

The serving default, ``PipelineConfig.int8_conv=True``, runs the UNet's
resnet / down / upsample 3x3 convs and the VAE decoder's convs in int8
(``ops.int8``); ``enable_int8_conv(False)`` restores exact convs on the
same weights; the int8 sites' quantised weights are built once per weights
version (``models.layers.prepare_int8``), when the pipeline is built, when
int8 is switched on and after a LoRA merge.  ``load_lora_weights`` and
``load_textual_inversion`` are the reference's loaders.

``enable_mesh`` serves one clip over several cards, one process per card
(``parallel``): every rank runs the encoders, the random draws and the DDIM
update whole; each UNet evaluation's CFG-doubled clips split over ``data``
and their frames over ``seq`` where they divide, the attention heads over
``tensor``; its eps is gathered on every rank; the decode splits the frames
over ``data`` x ``seq``.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import itertools
import os
from typing import List, Mapping, Optional, Sequence, Tuple, Union

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
from i2v_adapter_tpu_torch.models.layers import prepare_int8
from i2v_adapter_tpu_torch.models.vae import decode_sharded, decode_sliced, decode_tiled
from i2v_adapter_tpu_torch.ops import launches
from i2v_adapter_tpu_torch.ops.blur import gaussian_blur
from i2v_adapter_tpu_torch.ops.freeu import FreeUParams
from i2v_adapter_tpu_torch.ops.int8 import weights_key
from i2v_adapter_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, gather, shard
from i2v_adapter_tpu_torch.parallel.spmd import attention_spmd, shard_tensor_parallel, unshard_tensor_parallel
from i2v_adapter_tpu_torch.pipelines.tiling import temporal_windows, tiled_unet_call, window_weight_tensors
from i2v_adapter_tpu_torch.schedulers import add_noise, ddim_schedule_arrays, ddim_step, make_schedule
from i2v_adapter_tpu_torch.utils import convert
from i2v_adapter_tpu_torch.utils import image as image_utils
from i2v_adapter_tpu_torch.utils import lora, tracing
from i2v_adapter_tpu_torch.utils.convert import load_flax_params
from i2v_adapter_tpu_torch.utils.tokenizer import CLIPTokenizer


def _encoder_cache_elems_per_eval(ucfg, lh: int, lw: int) -> int:
    """Elements of one frame-evaluation's ``(x, skips)`` encoder cache (the
    down path's conv_in skip, per-layer and downsample skips and its
    output), which sizes ``encoder_cache=2``'s footprint before a call."""
    h, w = lh, lw
    n = len(ucfg.block_out_channels)
    elems = h * w * ucfg.block_out_channels[0]  # conv_in skip
    for i, ch in enumerate(ucfg.block_out_channels):
        elems += ucfg.layers_per_block * h * w * ch
        if i < n - 1:
            h, w = -(-h // 2), -(-w // 2)
            elems += h * w * ch  # downsample skip
    elems += h * w * ucfg.block_out_channels[-1]  # down-path output x
    return elems


def cfg_steps(cfg_cutoff: float, n_steps: int) -> int:
    """The number of leading CFG steps under ``cfg_cutoff`` (the rest run the
    conditional half only): ``round(cutoff * steps)``, Python's half to even,
    as the JAX sampler counts them."""
    return n_steps if cfg_cutoff >= 1.0 else int(round(cfg_cutoff * n_steps))


def step_kinds(n_steps: int, encoder_cache: int, n_cfg: int) -> List[str]:
    """Each denoise step's kind, as the JAX samplers order them: with
    ``encoder_cache=2`` pairs of a ``'full'`` step (which keeps the UNet's
    down-path features) and a ``'cached'`` one, an odd trailing step
    ``'cfg'`` (exact); otherwise ``n_cfg`` ``'cfg'`` steps, then ``'cond'``
    (the conditional half only)."""
    n_pairs = n_steps - n_steps % 2 if encoder_cache > 1 else 0
    return [("full" if i % 2 == 0 else "cached") if i < n_pairs else ("cfg" if i < n_cfg else "cond")
            for i in range(n_steps)]


def meshed_unet_eval(mesh, evaluate, x: torch.Tensor, text_states: torch.Tensor, image_embeds):
    """One UNet evaluation of ``x (rows, frames, h, w, c)`` over ``mesh``:
    ``evaluate(x, text_states, image_embeds)`` runs on this rank's slab --
    the rows (CFG-doubled clips) over ``data`` and the frames over ``seq``,
    each where it divides, as the JAX ``shard_evals`` lays them out -- inside
    the slab's ``attention_spmd`` context, and the eps is gathered on every
    rank.  ``evaluate`` may also return the slab's down-path features
    (``return_encoder``), which stay the rank's.  Without a mesh, just
    ``evaluate`` on the whole input."""
    if mesh is None:
        return evaluate(x, text_states, image_embeds)
    rows, frames = x.shape[:2]
    clip_split = rows % mesh.size(DATA_AXIS) == 0
    frame_split = frames % mesh.size(SEQ_AXIS) == 0
    if clip_split:
        x, text_states = shard(x, 0, mesh, DATA_AXIS), shard(text_states, 0, mesh, DATA_AXIS)
        image_embeds = None if image_embeds is None else shard(image_embeds, 0, mesh, DATA_AXIS)
    if frame_split:
        x = shard(x, 1, mesh, SEQ_AXIS)
    with attention_spmd(mesh, clip_split=clip_split, frame_split=frame_split, frames=frames):
        out = evaluate(x, text_states, image_embeds)
    eps, enc = out if isinstance(out, tuple) else (out, None)
    if frame_split:
        eps = gather(eps, 1, mesh, SEQ_AXIS)
    if clip_split:
        eps = gather(eps, 0, mesh, DATA_AXIS)
    return eps if enc is None else (eps, enc)


def span_views(root) -> Tuple[dict, dict]:
    """``(last_timings, last_dispatch)`` of one request's spans (or of a
    denoise loop's, driven directly): ``prep_ms`` and ``decode_ms`` (host ms
    between synchronisations), ``step_ms`` (each step's device ms where the
    steps were timed on the card, else its host ms); the request's
    ``dispatch`` and, under ``'scan'``, each ``capture_ms``, the loop's
    ``graph_pool_bytes`` and its ``graph_cache`` state."""
    prep, decode = root.find("prep"), root.find("decode")
    timings = {"prep_ms": prep[-1].ms} if prep else {}
    timings["step_ms"] = [s.ms if s.device_ms is None else s.device_ms for s in root.find("step")]
    if decode:
        timings["decode_ms"] = decode[-1].ms
    dispatch = {} if root.name == "denoise" else dict(root.attrs)
    for s in root.unit + [root]:
        if s.name == "denoise" and "graph_cache" in s.attrs:
            dispatch.update(capture_ms=[c.ms for c in root.find("capture")], **s.attrs)
    return timings, dispatch


_SCAN_STREAMS: dict = {}


def _scan_stream(device: torch.device) -> "torch.cuda.Stream":
    """The scan dispatch's side stream of ``device``, one per device for the
    process: the allocator's blocks cached on it and the library workspaces
    made for it (cuBLAS keeps one per stream, about 32 MB) are reused by
    every call."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SCAN_STREAMS:
        _SCAN_STREAMS[index] = torch.cuda.Stream(index)
    return _SCAN_STREAMS[index]


class StepGraphs:
    """The ``dispatch='scan'`` denoise loop: every step reads and writes
    static buffers (the latents, the timesteps ``t`` and ``t_prev`` as
    device scalars, the eta noise, the consts: condition latents, text
    states and image embeds), so a step kind ("cfg", "full", "cached",
    "cond"; ``step_kinds``) is one fixed program.

    On the card the first step of a kind runs eagerly (the warm-up that
    capture needs; its result is the step's), the kind's second step is
    captured into a CUDA graph and replayed, and every later step of the
    kind is a replay: no host work inside a step beyond writing ``t``,
    ``t_prev`` and the noise into their buffers, and no host sync.  Graphs
    alive together share one private memory pool.  The pipeline keeps one
    ``StepGraphs`` per shape bucket across calls (``load`` copies a call's
    consts and starting latents into the buffers the graphs read, so a
    later call replays what an earlier one captured); a loop that is not
    kept drops a kind's graph after its last step (``release``) and all of
    them at the end (``close``), so the memory is the decoder's again (the
    allocator returns a released pool's blocks to the card when an
    allocation needs them).  The launch counters count each replay
    (``ops.launches``).  On the CPU every step runs the same static-buffer
    program eagerly.  With ``eta > 0`` the noise is drawn from
    ``generator`` before each step, in the order the stepwise loop draws it,
    so both dispatches give the same clip.  A capture or replay that fails
    raises; there is no fallback to the eager loop."""

    def __init__(self, parts, consts, latents: torch.Tensor, generator=None, eta: float = 0.0):
        _, step_fn, _, _, _, (step_full, step_cached, step_cond) = parts
        self.step_fns = {"cfg": step_fn, "full": step_full, "cached": step_cached, "cond": step_cond}
        self.consts, self.generator = consts, generator
        dev = latents.device
        self.cuda = dev.type == "cuda"
        self.latents = latents.clone()
        self.t = torch.zeros((), dtype=torch.long, device=dev)
        self.tp = torch.zeros((), dtype=torch.long, device=dev)
        self.noise = torch.empty_like(self.latents) if eta > 0.0 else None
        self.caches = None  # the last 'full' step's down-path features
        self.graphs, self.counts, self.seen = {}, {}, set()
        self.pool_bytes = 0  # the card memory the captures reserved

    def load(self, consts, latents: torch.Tensor, generator=None) -> None:
        """Start another call on the kept buffers: its consts and starting
        latents copied in place (the graphs read them by address), its
        generator for the eta noise."""
        for dst, src in zip(self.consts, consts):
            if dst is not None:
                dst.copy_(src)
        self.latents.copy_(latents)
        self.generator = generator

    def _body(self, kind: str) -> None:
        args = (self.consts, self.latents, self.t, self.tp)
        if kind == "full":
            new, self.caches = self.step_fns["full"](*args, eta_noise=self.noise)
        elif kind == "cached":
            new = self.step_fns["cached"](*args, self.caches, eta_noise=self.noise)
        else:
            new = self.step_fns[kind](*args, eta_noise=self.noise)
        self.latents.copy_(new)

    def step(self, kind: str, t, tp) -> None:
        """One denoise step of ``kind`` from timestep ``t`` to ``tp``, queued
        on the current stream."""
        self.t.fill_(int(t))
        self.tp.fill_(int(tp))
        if self.noise is not None:
            self.noise.copy_(torch.randn(self.latents.shape, generator=self.generator, device=self.latents.device))
        if kind not in self.graphs and self.cuda and kind in self.seen:
            self._capture(kind)
        if kind in self.graphs:
            launches.replay(self.graphs[kind], self.counts[kind])
        else:
            self._body(kind)
            self.seen.add(kind)

    def _capture(self, kind: str) -> None:
        # the pool reserves up to about twice the eager step's working set,
        # which the allocator keeps cached (nothing can be returned to the
        # card while a capture runs): return the cached blocks first when the
        # card could not hold both
        if torch.cuda.mem_get_info()[0] < 2 * (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()):
            torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        # graphs alive together share the first one's pool (they replay in
        # the order they were captured); a graph with none alive beside it
        # starts a pool of its own.  Captured on the current (side) stream.
        shared = next(iter(self.graphs.values()), None)
        with tracing.span("capture", kind=kind):
            self.graphs[kind], self.counts[kind] = launches.capture(
                lambda: self._body(kind), pool=shared.pool() if shared is not None else None)
        self.pool_bytes += torch.cuda.memory_reserved() - reserved

    def release(self, kind: str) -> None:
        """Drop ``kind``'s graph (its last step has been queued); the pool's
        blocks go back to the allocator once no graph holds them."""
        self.graphs.pop(kind, None)
        if kind == "cached":
            self.caches = None

    def close(self) -> None:
        self.graphs.clear()
        self.caches = None


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
        # views of the last request's spans (span_views): its phases' ms;
        # its dispatch, and under 'scan' its captures' host ms, the graphs'
        # pool bytes and the graph cache's state
        self.last_timings: dict = {}
        self.last_dispatch: dict = {}
        self.mesh = None
        self.prepare_int8()

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
        The IP-Adapter's head variant (standard, plus or full_face) and its
        geometry are read from its keys; a plus or full_face head whose
        input width is not the image encoder's hidden size, or a full_face
        head whose token count (its layout's, 257) is not the image
        encoder's (patches + 1), is refused with ``ValueError`` before the
        UNet is read.

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
            ucfg, hidden = model_config.unet, model_config.image_encoder.hidden_size
            if ucfg.ip_variant != "standard" and ucfg.ip_hidden_dim != hidden:
                raise ValueError(
                    f"the IP-Adapter {ucfg.ip_variant} head reads {ucfg.ip_hidden_dim}-wide hidden "
                    f"states, the image encoder gives {hidden}")
            enc = model_config.image_encoder
            tokens = (enc.image_size // enc.patch_size) ** 2 + 1
            if ucfg.ip_variant == "full_face" and ucfg.ip_num_tokens != tokens:
                raise ValueError(
                    f"the IP-Adapter full_face head carries {ucfg.ip_num_tokens} image tokens, the image "
                    f"encoder gives {tokens} ({enc.image_size} px in {enc.patch_size} px patches, + 1)")
        unet = VideoUNet(model_config.unet, device=device)
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
        elif cls is VideoUNet:
            value.set_int8(cfg.int8_conv)
            value.set_freeu(cfg.freeu)
        elif cls is AutoencoderKL:
            value.set_int8(cfg.int8_decode)
        return value.to(self.device, self.dtype).eval()

    # ------------------------------------------------------------------
    # serving one clip over several cards
    # ------------------------------------------------------------------

    def enable_mesh(self, mesh) -> None:
        """Serve over ``mesh`` (``parallel.mesh.create_mesh``, this rank's
        place; every rank of the group calls this and then every request in
        the same order): the UNet's attention projections sliced to this
        rank's ``tensor`` heads, each evaluation split over ``data`` and
        ``seq`` (``meshed_unet_eval``).  The kept step graphs are
        dropped, as the JAX package clears its samplers; ``disable_mesh``
        reverts."""
        if getattr(self, "mesh", None) is not None:
            self.disable_mesh()
        if mesh.device != self.device:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the pipeline on {self.device}")
        shard_tensor_parallel(self.unet, mesh)
        self.mesh = mesh
        self.release_graphs()

    def disable_mesh(self) -> None:
        unshard_tensor_parallel(self.unet)
        self.mesh = None
        self.release_graphs()

    def _mesh_parallelism(self) -> int:
        """Ranks one evaluation's frame-evaluations split over: data x seq
        (what the memory envelopes scale by, as in the JAX package)."""
        mesh = getattr(self, "mesh", None)
        return 1 if mesh is None else mesh.size((DATA_AXIS, SEQ_AXIS))

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
        self.release_graphs()
        self.prepare_int8()

    def prepare_int8(self) -> int:
        """Quantise the int8 sites' weights whose cached pair is missing or
        stale (built, cast, moved or written since), in one grouped kernel
        launch on the card; returns how many sites were quantised.  Run when
        the pipeline is built, when int8 is switched on, after a LoRA merge
        and at the start of every call (a no-op while nothing changed).
        Quantising stores new ``(wq, ws)`` tensors, so the kept step graphs,
        which read the old ones by address, are dropped."""
        quantised = prepare_int8(self.unet, self.vae)
        if quantised:
            self.release_graphs()
        return quantised

    def load_lora_weights(self, path: str, scale: float = 1.0) -> int:
        """Merge a LoRA checkpoint (peft or kohya layout; ``utils.lora``) into
        the UNet's weights; returns the number of patched layers.  The
        patched int8 sites are quantised again at once, and the kept step
        graphs are dropped (the next ``'scan'`` call captures afresh)."""
        if getattr(self, "mesh", None) is not None:
            raise ValueError("merge a LoRA before enable_mesh (the mesh slices the attention projections)")
        patched = lora.merge_lora(self.unet, convert.load_state_dict(path), scale)
        self.release_graphs()
        self.prepare_int8()
        return patched

    def load_textual_inversion(self, path: str, token: str) -> None:
        """Load a learned embedding (the A1111 ``string_to_param`` file or the
        diffusers ``{token: tensor}`` one) and register ``token``; the text
        encoder's vocabulary grows by its rows."""
        sd = convert.load_state_dict(path)
        if "string_to_param" in sd:  # A1111 format
            emb = list(sd["string_to_param"].values())[0]
        elif len(sd) == 1:  # diffusers format: {token: tensor}
            emb = list(sd.values())[0]
        else:
            raise ValueError(f"unrecognized textual-inversion format: {list(sd)[:4]}")
        lora.load_textual_inversion(self.text_encoder, self.tokenizer, np.asarray(emb), token)
        self.config = self.config.replace(text_encoder=self.text_encoder.config)
        self.release_graphs()

    def enable_freeu(self, s1: float = 0.9, s2: float = 0.2, b1: float = 1.2, b2: float = 1.4) -> None:
        """FreeU skip re-weighting on the UNet's up path (``VideoUNetConfig.
        freeu``); the weights are unchanged, so nothing is reloaded."""
        self.config = self.config.replace(unet=self.config.unet.replace(freeu=(s1, s2, b1, b2)))
        self.unet.set_freeu(FreeUParams(s1, s2, b1, b2))
        self.release_graphs()

    def disable_freeu(self) -> None:
        self.config = self.config.replace(unet=self.config.unet.replace(freeu=None))
        self.unet.set_freeu(None)
        self.release_graphs()

    # ------------------------------------------------------------------
    # the kept step graphs (the JAX package's ``_sampler_cache``)
    # ------------------------------------------------------------------

    def _graph_cache(self) -> "collections.OrderedDict[tuple, StepGraphs]":
        """The ``'scan'`` step programs kept across calls, one ``StepGraphs``
        per shape bucket, least recently used first.  Made on first use
        (``__dict__.setdefault``), so a pipeline built without ``__init__``
        has one too."""
        return self.__dict__.setdefault("_graphs", collections.OrderedDict())

    def release_graphs(self) -> None:
        """Drop every kept step program and its pool: where the JAX package
        clears its ``_sampler_cache`` (FreeU on or off, int8 on or off, a
        LoRA merge, a textual inversion), when the int8 weights are
        quantised again, and when a caller swaps the UNet's weights (the
        trainer's validation; the daemon after a failed request)."""
        self._graph_cache().clear()

    def _graph_weights_changed(self) -> bool:
        """Whether any UNet parameter or buffer was replaced or written in
        place since the last check (its storage and write count,
        ``ops.int8.weights_key``): a kept graph would read the old values,
        so the caller drops them."""
        seen = tuple(weights_key(t) for t in itertools.chain(self.unet.parameters(), self.unet.buffers()))
        changed = self.__dict__.get("_graph_weights") != seen
        self._graph_weights = seen
        return changed

    def _trim_graphs(self, room: int, spare: Optional[tuple] = None) -> None:
        """Drop kept step programs, least recently used first, until the
        pools of those but ``spare``'s hold at most ``room`` bytes."""
        cache = self._graph_cache()
        others = [key for key in cache if key != spare]
        while others and sum(cache[key].pool_bytes for key in others) > room:
            del cache[others.pop(0)]

    def _graph_rooms(self, eval_tokens: int, cache_bytes: int, decode_tokens: int) -> Tuple[int, int]:
        """Bytes the kept step graphs may hold beside a request's denoise
        (``eval_tokens`` frame-evaluations x latent tokens at once, its
        encoder cache) and beside its decode (``decode_tokens`` decoded
        frames x latent tokens per decoder call), within
        ``MAX_KEPT_GRAPH_BYTES``."""
        room = self.MAX_DECODE_TOKENS * self.DECODE_TOKEN_BYTES
        denoise = room - 2 * eval_tokens * self.EVAL_TOKEN_BYTES - cache_bytes
        decode = room - decode_tokens * self.DECODE_TOKEN_BYTES
        return min(self.MAX_KEPT_GRAPH_BYTES, denoise), min(self.MAX_KEPT_GRAPH_BYTES, decode)

    # ------------------------------------------------------------------
    # the parts
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
        decode_slice: int = 0,
        vae_tiling: bool = False,
        unet_chunk: int = 1,
    ):
        """(prep_fn, step_fn, decode_fn, timesteps, prev_timesteps,
        (step_full_fn, step_cached_fn, step_cond_fn)), as the JAX package's.

        ``prep_fn(text_ids, cond_image, clip_image, generator, ...)
            -> (latents, consts)`` with consts = (cond_latents, text_states,
            image_embeds); the posterior noise, the prior's mask draw and
            noise come from ``generator`` unless passed in; without a
            condition image ``init_latents`` (when given) are the start.
        ``step_fn(consts, latents, t, t_prev, generator=None, *,
            eta_noise=None) -> latents``: first-frame clamp, CFG-doubled
            UNet, guidance, DDIM update (with ``eta > 0`` the noise is
            ``eta_noise`` when given, else drawn from the generator).  ``t``
            and ``t_prev`` are host integers (the stepwise loop) or 0-d
            int64 device tensors (``StepGraphs``' static timesteps: the
            time embedding and the DDIM coefficients are then formed on the
            device, with no host value inside the step).
        ``step_full_fn`` is ``step_fn`` that also returns the UNet's
        down-path features, ``step_cached_fn(consts, latents, t, t_prev,
        caches, ...)`` reuses them at the next timestep (``encoder_cache=2``),
        and ``step_cond_fn`` runs the conditional half only, without
        guidance (``cfg_cutoff``).
        ``decode_fn(consts, latents) -> (B, F, H, W, 3)`` float video.

        Every UNet evaluation runs the CFG-doubled batch in ``unet_chunk``
        chunks of clips when that divides it (the encoder caches are kept
        per chunk), and clips longer than ``motion_max_seq_length`` in
        anchored temporal windows (caches per window).  ``vae_tiling`` /
        ``decode_slice`` select the tiled or sliced decode."""
        cfg, pcfg = self.config, self.pipe_config
        dev, dtype, schedule = self.device, self.dtype, self.schedule
        # the step functions hold the UNet, not the pipeline: a kept
        # StepGraphs referring back to its pipeline would make a reference
        # cycle, and a dropped pipeline's graphs would hold their pools until
        # the cyclic collector ran
        unet = self.unet
        mesh = getattr(self, "mesh", None)
        scale = cfg.vae.scaling_factor
        f = num_frames
        sf = cfg.vae.spatial_scale_factor
        lh, lw = height // sf, width // sf
        ts, prev = ddim_schedule_arrays(
            cfg.scheduler, num_inference_steps, strength if has_condition else 1.0
        )
        prior_shape = (batch, f, lh, lw, cfg.unet.in_channels)
        motion_cap = cfg.unet.motion_max_seq_length
        use_tiling = num_frames > motion_cap
        # anchored windows prepend the first frame: leave room under the cap
        window = min(pcfg.temporal_window, motion_cap - 1)
        stride = max(1, min(pcfg.temporal_stride, window - 1))
        # made here, not per step: a step replayed from a CUDA graph holds no
        # host-to-device copy
        window_weights = window_weight_tensors(f, window, stride, dev, torch.float32) if use_tiling else None
        device_schedule = make_schedule(cfg.scheduler, device=dev)

        def prep_fn(text_ids, cond_image, clip_image, generator=None, *,
                    posterior_noise=None, mask_uniform=None, prior_noise=None, init_latents=None):
            with tracing.span("text_encoder"):
                text_states = self.text_encoder(torch.as_tensor(text_ids, device=dev))
            image_embeds = None
            if cfg.unet.use_ip_adapter:
                with tracing.span("image_encoder"):
                    clip = torch.as_tensor(clip_image, device=dev)
                    if cfg.unet.ip_variant == "standard":
                        image_embeds = self.image_encoder(clip)
                        uncond = torch.zeros_like(image_embeds)
                    else:  # plus / full_face read the penultimate hidden states;
                        # the unconditional branch encodes a zero image
                        image_embeds = self.image_encoder(clip, output_hidden_state=True)[1]
                        uncond = self.image_encoder(torch.zeros_like(clip), output_hidden_state=True)[1]
                    if use_cfg:
                        image_embeds = torch.cat([uncond, image_embeds])
            if not has_condition:
                with tracing.span("prior"):
                    if init_latents is not None:
                        latents = torch.as_tensor(init_latents, device=dev).float()
                    else:
                        latents = torch.randn(prior_shape, generator=generator, device=dev)
                return latents, (None, text_states, image_embeds)
            if posterior_noise is None and generator is None:
                raise ValueError("prep_fn needs a generator or the posterior noise")
            with tracing.span("vae_encode"):
                cond = torch.as_tensor(cond_image, device=dev).to(dtype)
                cond_latents = self.vae.encode(cond, noise=posterior_noise, generator=generator) * scale
            with tracing.span("prior"):
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

        def local_eval(x, t, text_states, image_embeds, **kw):
            ts = t.float().expand(x.shape[0]) if torch.is_tensor(t) else torch.full(
                (x.shape[0],), float(t), device=dev)
            return unet(x.to(dtype), ts, text_states, image_embeds, enable_cross_frame_attn=has_condition, **kw)

        def unet_eval(x, t, text_states, image_embeds, **kw):
            return meshed_unet_eval(mesh, lambda xs, text, img: local_eval(xs, t, text, img, **kw), x,
                                    text_states, image_embeds)

        def chunks(n):
            per = n // unet_chunk if unet_chunk > 1 and n % unet_chunk == 0 else n
            return [slice(i, i + per) for i in range(0, n, per)]

        def rows(a, sl):
            return None if a is None else a[sl]

        # one UNet evaluation of a (possibly CFG-doubled) batch, chunked
        def unet_call(x, t, text, img):
            return torch.cat([unet_eval(x[sl], t, rows(text, sl), rows(img, sl)).float()
                              for sl in chunks(x.shape[0])])

        def unet_full(x, t, text, img):
            outs = [unet_eval(x[sl], t, rows(text, sl), rows(img, sl), return_encoder=True)
                    for sl in chunks(x.shape[0])]
            return torch.cat([o.float() for o, _ in outs]), [enc for _, enc in outs]

        def unet_cached(x, t, text, img, caches):
            return torch.cat([unet_eval(x[sl], t, rows(text, sl), rows(img, sl), cached_encoder=enc).float()
                              for sl, enc in zip(chunks(x.shape[0]), caches)])

        # the same, over the temporal windows of a clip past the motion cap
        def evaluate(x, t, text, img):
            if use_tiling:
                return tiled_unet_call(lambda xw, anchored: unet_call(xw, t, text, img), x, window, stride,
                                       weights=window_weights)
            return unet_call(x, t, text, img)

        def evaluate_full(x, t, text, img):
            if use_tiling:
                return tiled_unet_call(lambda xw, anchored, cache: unet_full(xw, t, text, img), x,
                                       window, stride, collect_caches=True, weights=window_weights)
            return unet_full(x, t, text, img)

        def evaluate_cached(x, t, text, img, caches):
            if use_tiling:
                return tiled_unet_call(lambda xw, anchored, cache: unet_cached(xw, t, text, img, cache), x,
                                       window, stride, caches=caches, weights=window_weights)
            return unet_cached(x, t, text, img, caches)

        def clamp(latents, consts):
            if has_condition:
                latents = latents.clone()
                latents[:, 0] = consts[0].to(latents.dtype)
            return latents

        def cfg_input(latents):
            return torch.cat([latents, latents]) if use_cfg else latents

        def update(noise_pred, latents, t, tp, generator, eta_noise, guided=use_cfg):
            if guided:
                uncond, text = noise_pred.chunk(2)
                noise_pred = uncond + guidance_scale * (text - uncond)
            if pcfg.eta <= 0.0:
                eta_noise = None
            elif eta_noise is None:
                eta_noise = torch.randn(latents.shape, generator=generator, device=dev)
            if torch.is_tensor(t):  # device timesteps: the schedule's tables on the device too
                sched, tv, tpv = device_schedule, t.expand(batch), tp.expand(batch)
            else:
                sched, tv, tpv = schedule, torch.full((batch,), int(t)), torch.full((batch,), int(tp))
            return ddim_step(sched, noise_pred, tv, tpv, latents, eta=pcfg.eta, noise=eta_noise)

        def step_fn(consts, latents, t, tp, generator=None, *, eta_noise=None):
            latents = clamp(latents, consts)
            noise_pred = evaluate(cfg_input(latents), t, consts[1], consts[2])
            return update(noise_pred, latents, t, tp, generator, eta_noise)

        def step_full_fn(consts, latents, t, tp, generator=None, *, eta_noise=None):
            latents = clamp(latents, consts)
            noise_pred, caches = evaluate_full(cfg_input(latents), t, consts[1], consts[2])
            return update(noise_pred, latents, t, tp, generator, eta_noise), caches

        def step_cached_fn(consts, latents, t, tp, caches, generator=None, *, eta_noise=None):
            latents = clamp(latents, consts)
            noise_pred = evaluate_cached(cfg_input(latents), t, consts[1], consts[2], caches)
            return update(noise_pred, latents, t, tp, generator, eta_noise)

        def step_cond_fn(consts, latents, t, tp, generator=None, *, eta_noise=None):
            _, text_states, image_embeds = consts
            if use_cfg:  # the consts are [uncond; cond] along the batch
                text_states = text_states[batch:]
                image_embeds = rows(image_embeds, slice(batch, None))
            latents = clamp(latents, consts)
            noise_pred = evaluate(latents, t, text_states, image_embeds)
            return update(noise_pred, latents, t, tp, generator, eta_noise, guided=False)

        def decode_fn(consts, latents):
            latents = clamp(latents, consts)
            flat = (latents.reshape(batch * f, lh, lw, cfg.unet.in_channels) / scale).to(dtype)
            if vae_tiling:
                video = decode_tiled(self.vae.decode, flat)
            elif decode_slice <= 0 or decode_slice >= batch * f:
                video = self.vae.decode(flat) if mesh is None else decode_sharded(self.vae.decode, flat, mesh)
            else:
                video = decode_sliced(self.vae.decode, flat, decode_slice)
            return video.reshape(batch, f, height, width, cfg.vae.out_channels).float()

        return prep_fn, step_fn, decode_fn, ts, prev, (step_full_fn, step_cached_fn, step_cond_fn)

    # ------------------------------------------------------------------
    # user entry point
    # ------------------------------------------------------------------

    # unet_chunk=0 chunks the UNet's batch in two once the frame-evaluations
    # x latent tokens of a step reach this.  Kept as the JAX package's rule,
    # not sized for this card: under int8 each chunk takes its own
    # activation scale, so the rule decides which clip a request gives, and
    # one request gives the same clip on both packages.
    UNET_CHUNK_AUTO_EVAL_TOKENS: int = 256 * 4096

    # The card's memory budgets, from chip_smoke.py's serve_heads line (its
    # "memory" record) on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
    # --query-gpu=name,power.limit), serving default, bf16: 85.0 GB on the
    # card, 5.12 GB of weights (I2VModelConfig(), its int8 sites' quantised
    # copies included), one 512 px UNet evaluation 89.4 MB per
    # frame-evaluation (linear from 32 to 576, no fixed part), one decoded
    # 512 px frame 1.21 GB (linear from 8 to 48).  90 % of the card is
    # planned for (the CUDA context, the allocator's fragmentation and the
    # library workspaces take the rest); three quarters of what the weights
    # leave go to one evaluation (592 frame-evaluations at 512 px; 576
    # kept), the last quarter to encoder_cache=2's features (17 GB; 16 GB
    # kept); the decode, which runs alone, gets all of it (59 frames at
    # 512 px; 56 kept).  Under dispatch='scan' the graphs' pool takes the
    # eager step's place (it reserves 1.6-1.8x the step's allocation): a
    # 'scan' request at the evaluation envelope reserved 57 % of the card.
    #
    # The single-card envelope: frame-evaluations x latent tokens that one
    # UNet evaluation may hold at once.
    MAX_EVAL_TOKENS: int = 576 * 4096

    # encoder_cache=2 keeps every chunk's and window's down-path features
    # alive across the step pair, on top of the weights and the working set
    # of one evaluation (a 16-frame CFG step at 512 px holds 0.43 GB).
    MAX_ENC_CACHE_BYTES: int = 16_000_000_000

    # The VAE decode's envelope: frames per decoder call x latent tokens per
    # frame (a tile's under vae_tiling).  The decoder's working set grows
    # with the frames it decodes at once; the UNet's is freed by then.
    MAX_DECODE_TOKENS: int = 56 * 4096

    # the card these budgets were measured on (named in their errors)
    MEMORY_BUDGET_CARD: str = "NVIDIA H100 80GB HBM3"

    # The same record's slopes: bytes of one UNet evaluation per
    # frame-evaluation x latent token (89.4 MB / 4096), and of one decoder
    # call per decoded frame x latent token (1.21 GB / 4096).  They size
    # what a request leaves for the kept step graphs.
    EVAL_TOKEN_BYTES: int = 21_830
    DECODE_TOKEN_BYTES: int = 295_400

    # The pools of the step graphs kept across 'scan' calls (one entry per
    # shape bucket, least recently used dropped first) hold at most this
    # together, and at most what the request being served leaves of the
    # decode envelope's bytes (MAX_DECODE_TOKENS x DECODE_TOKEN_BYTES, the
    # card's room beside the weights): beside its denoise, less twice its
    # evaluation's bytes (a pool reserves up to about twice the eager step)
    # and its encoder cache; beside its decode, less the decode's bytes.  A
    # request whose own pool would not fit beside its decode is captured
    # for the call and released before the decode.
    MAX_KEPT_GRAPH_BYTES: int = 16_000_000_000

    # dispatch='auto' takes the scan when the clip's UNet work (steps x
    # frame-evaluations x latent tokens, every temporal window counted) is at
    # most this: the JAX package's rule and constant, so that one request
    # takes the same dispatch on both packages.
    SCAN_DISPATCH_MAX_WORK: int = 8_000_000

    def _resolve_dispatch(self, dispatch: str, callback, steps: int, batch: int, num_frames: int,
                          window: Optional[int], use_cfg: bool, tokens: int) -> str:
        """``'scan'`` or ``'stepwise'``, as the JAX ``__call__`` decides: a
        callback forces ``'stepwise'``; ``'auto'`` compares the clip's UNet
        work with ``SCAN_DISPATCH_MAX_WORK``."""
        if callback is not None:
            return "stepwise"
        if dispatch != "auto":
            return dispatch
        if window is not None:
            stride = max(1, min(self.pipe_config.temporal_stride, window - 1))
            per_step_frames = sum((e - s) + (1 if s > 0 else 0)
                                  for s, e in temporal_windows(num_frames, window, stride))
        else:
            per_step_frames = num_frames
        work = steps * batch * per_step_frames * (2 if use_cfg else 1) * tokens
        return "stepwise" if work > self.SCAN_DISPATCH_MAX_WORK else "scan"

    def _denoise(self, parts, consts, latents, encoder_cache: int, n_cfg: int, generator=None,
                 callback=None, callback_steps: int = 1, views: bool = True):
        """The stepwise denoise loop over ``parts`` (``_build_parts``' result),
        as the JAX stepwise sampler drives its parts, step by ``step_kinds``,
        in a ``denoise`` span.  Each step is a ``step`` span between two
        synchronisations (``last_timings["step_ms"]``); ``callback(i, t,
        latents)`` runs after every ``callback_steps``-th step; ``views``
        (a loop driven directly): ``_top``."""
        _, step_fn, _, ts, prev, (step_full, step_cached, step_cond) = parts
        fns = {"cfg": step_fn, "cond": step_cond}
        caches = None
        with self._top("denoise", views):
            self._sync()
            for i, (kind, t, tp) in enumerate(zip(step_kinds(len(ts), encoder_cache, n_cfg), ts, prev)):
                with tracing.span("step", device_ms=False):
                    if kind == "full":
                        latents, caches = step_full(consts, latents, t, tp, generator=generator)
                    elif kind == "cached":
                        latents, caches = step_cached(consts, latents, t, tp, caches, generator=generator), None
                    else:
                        latents = fns[kind](consts, latents, t, tp, generator=generator)
                    self._sync()
                if callback is not None and i % callback_steps == 0:
                    callback(i, int(t), latents)
                    self._sync()
            return latents

    def _denoise_scan(self, parts, consts, latents, encoder_cache: int, n_cfg: int, generator=None,
                      keep: Optional[tuple] = None, room: Optional[int] = None, views: bool = True):
        """The same loop from ``StepGraphs``, on a side stream of the card
        (the current stream waits for it at the end), in a ``denoise`` span
        whose children are the ``empty_cache`` before the loop, each
        ``capture`` (its host ms: ``last_dispatch["capture_ms"]``) and each
        ``step``, timed on the card by CUDA events read once after the loop
        (``last_timings["step_ms"]``); the loop's pool goes to
        ``last_dispatch["graph_pool_bytes"]``.  With ``keep`` (the shape
        bucket's key) the loop is kept in the graph cache for later calls:
        found there, it takes this call's consts and starting latents into
        its buffers and replays the kinds it captured before
        (``last_dispatch["graph_cache"]["hit"]``).  Without it the graphs
        and their pool are released by the end of the loop.  With ``room``
        the kept loops are then trimmed to hold at most that many bytes;
        ``views`` (a loop driven directly): ``_top``."""
        ts, prev = parts[3], parts[4]
        kinds = step_kinds(len(ts), encoder_cache, n_cfg)
        last_use = {kind: i for i, kind in enumerate(kinds)}
        cuda = self.device.type == "cuda"
        cache = self._graph_cache()
        with self._top("denoise", views) as span:
            loop = cache.pop(keep, None) if keep is not None else None
            hit = loop is not None
            if not hit:  # its buffers made on the current stream, before the side stream waits for it
                loop = StepGraphs(parts, consts, latents, generator, self.pipe_config.eta)
                self._graph_builds = self.__dict__.get("_graph_builds", 0) + 1
            side = None
            if cuda:
                # blocks cached by earlier work (a previous clip's decode) go back
                # to the card now, while it idles after prep: the graphs' pool is
                # then made beside the eager steps' working set without emptying
                # the cache at a capture, where it would stall the card
                with tracing.span("empty_cache"):
                    torch.cuda.empty_cache()
                side = _scan_stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                if hit:
                    loop.load(consts, latents, generator)
                for i, (kind, t, tp) in enumerate(zip(kinds, ts, prev)):
                    with tracing.span("step", device_ms=cuda):
                        loop.step(kind, t, tp)
                    if keep is None and last_use[kind] == i:
                        loop.release(kind)
            if cuda:
                torch.cuda.current_stream(self.device).wait_stream(side)
                side.synchronize()
            if keep is None:
                latents = loop.latents
                loop.close()
            else:  # the buffer is the next call's: hand out a copy
                latents = loop.latents.clone()
                cache[keep] = loop
            if room is not None:
                self._trim_graphs(room)
            span.attrs.update(graph_pool_bytes=loop.pool_bytes, graph_cache={
                "hit": hit, "builds": self._graph_builds, "kept": keep in cache, "entries": len(cache),
                "pool_bytes": sum(entry.pool_bytes for entry in cache.values())})
            return latents

    @contextlib.contextmanager
    def _top(self, name: str, views: bool):
        """The span ``name``; with ``views`` (a request, or a denoise loop
        driven directly) ``last_timings`` and ``last_dispatch`` become views
        of its spans once it has closed without an error (``span_views``)."""
        with tracing.span(name) as span:
            yield span
        if views:
            self.last_timings, self.last_dispatch = span_views(span)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_memory_envelope(self, evals: int, height: int, width: int, batch: int) -> None:
        """Refuse a request whose UNet working set exceeds the card's measured
        envelope before anything runs, instead of running the card out of
        memory."""
        sf = self.config.vae.spatial_scale_factor
        tokens = (height // sf) * (width // sf)
        # over a mesh each rank holds 1 / (data x seq) of an evaluation
        budget = self.MAX_EVAL_TOKENS * self._mesh_parallelism()
        if evals * tokens > budget:
            max_batch = max(1, budget // (tokens * (evals // batch)))
            raise ValueError(
                f"request of {evals} UNet frame-evals x {tokens} latent tokens exceeds the "
                f"memory envelope ({budget} eval-tokens: {self.MAX_EVAL_TOKENS} per card, measured on "
                f"an {self.MEMORY_BUDGET_CARD}, x {self._mesh_parallelism()}).  Split the request into "
                f"batches of <= {max_batch} clip(s) at this resolution, lower the resolution, or pass "
                f"memory_unsafe=True on a larger device.")

    def _check_decode_envelope(self, frames: int, tokens: int) -> None:
        """Refuse a request whose decoder calls would each decode more frame
        x latent tokens than the card's measured decode envelope."""
        if frames * tokens > self.MAX_DECODE_TOKENS:
            raise ValueError(
                f"decoding {frames} frames x {tokens} latent tokens at once exceeds the single-card "
                f"decode envelope ({self.MAX_DECODE_TOKENS} frame-tokens, measured on an "
                f"{self.MEMORY_BUDGET_CARD}).  Pass decode_slice <= "
                f"{max(1, self.MAX_DECODE_TOKENS // tokens)} (frames per decoder call), "
                f"vae_tiling=True, or memory_unsafe=True on a larger device.")

    def _encoder_cache_bytes(self, num_frames: int, height: int, width: int, batch: int, use_cfg: bool,
                             window: Optional[int]) -> Tuple[int, int]:
        """``encoder_cache=2``'s cached frame-evaluations (every window's and
        chunk's, alive across the step pair) and their down-path features'
        bytes."""
        sf = self.config.vae.spatial_scale_factor
        if window is not None:
            stride = max(1, min(self.pipe_config.temporal_stride, window - 1))
            frames = sum((e - s) + (1 if s > 0 else 0) for s, e in temporal_windows(num_frames, window, stride))
        else:
            frames = num_frames
        cached_evals = frames * batch * (2 if use_cfg else 1)
        return cached_evals, (cached_evals * _encoder_cache_elems_per_eval(self.config.unet, height // sf, width // sf)
                              * (2 if self.pipe_config.dtype == "bfloat16" else 4))

    def _check_encoder_cache_budget(self, num_frames: int, height: int, width: int, batch: int,
                                    use_cfg: bool, window: Optional[int]) -> None:
        """Refuse an ``encoder_cache=2`` request whose cached down-path
        features (every window's and chunk's, alive across the step pair)
        exceed ``MAX_ENC_CACHE_BYTES``."""
        cached_evals, cache_bytes = self._encoder_cache_bytes(num_frames, height, width, batch, use_cfg, window)
        budget = self.MAX_ENC_CACHE_BYTES * self._mesh_parallelism()
        if cache_bytes > budget:
            raise ValueError(
                f"encoder_cache=2 would hold ~{cache_bytes / 1e9:.1f} GB of down-path features "
                f"across the step pair ({cached_evals} cached frame-evals), over the "
                f"{budget / 1e9:.1f} GB cache budget ({self.MAX_ENC_CACHE_BYTES / 1e9:.1f} GB per card x "
                f"{self._mesh_parallelism()}) measured on an "
                f"{self.MEMORY_BUDGET_CARD}.  Use a smaller batch or resolution, disable "
                f"encoder_cache, or pass memory_unsafe=True on a larger device.")

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
        num_videos_per_prompt: int = 1,
        latents=None,
        seed: int = 0,
        output_type: str = "np",
        decode_slice: int = 0,
        vae_tiling: bool = False,
        unet_chunk: int = 0,
        memory_unsafe: bool = False,
        dispatch: str = "auto",
        encoder_cache: Optional[int] = None,
        cfg_cutoff: Optional[float] = None,
        callback=None,
        callback_steps: int = 1,
    ):
        """Generate clips: (B, F, H, W, 3) uint8 (``output_type='np'``),
        float32 in [-1, 1] (``'pt'`` or ``'float'``), or the final latents
        without a decode (``'latent'``: (B, F, h, w, 4) float32, the first
        frame clamped to the condition, still times ``scaling_factor``).
        The call is a ``request`` span (``utils.tracing``) whose children
        are ``inputs`` (the host's work before prep), ``prep`` (with
        ``text_encoder``, ``image_encoder``, ``vae_encode`` and ``prior``),
        ``denoise`` (its ``step`` spans), ``decode`` (with the allocator's
        counters) and ``finish`` (the copy to the host, the finite check and
        the uint8 conversion); ``self.last_timings`` and
        ``self.last_dispatch`` are views of them (``span_views``);
        ``'latent'`` has no ``decode_ms``.

        The arguments are the JAX ``__call__``'s:

        * ``num_videos_per_prompt``: each prompt and its condition and IP
          images repeat N times, interleaved.
        * ``latents``: initial latents (B*N, F, H/8, W/8, 4); a condition
          image's similarity prior replaces them, so they only shape the
          no-condition path.
        * ``decode_slice`` (frames per decoder call; 0 = all, auto 32 past 64
          frames, 2 for large frames), ``vae_tiling`` (spatially tiled
          decode), ``unet_chunk`` (clip chunks per UNet evaluation; 0 = the
          reference's auto rule).
        * ``memory_unsafe=True`` skips the card's memory envelopes (the UNet's
          and the decode's) and the encoder-cache budget.
        * ``dispatch``: ``'stepwise'`` runs the eager loop, one synchronised
          device pass per denoise step; ``'scan'`` runs the loop from static
          buffers, each step kind replayed from a CUDA graph with no host
          sync (``StepGraphs``), equal to ``'stepwise'``; the graphs are
          kept per shape bucket for later calls, as the JAX package keeps
          its compiled samplers (``last_dispatch["graph_cache"]``: hit or
          miss, kept or not, the entries and their pool bytes; the memory
          rule is ``MAX_KEPT_GRAPH_BYTES``'s); ``'auto'`` takes
          ``'scan'`` when the clip's UNet work is at most
          ``SCAN_DISPATCH_MAX_WORK`` eval-tokens and no callback is given,
          as the JAX package decides.  ``last_dispatch["dispatch"]`` says
          which ran.
        * ``encoder_cache=2``: every second denoise step reuses the previous
          step's UNet down-path features (pairs of a full and a cached step;
          an odd trailing step runs full).  ``cfg_cutoff`` in [0, 1]: the
          first ``round(cutoff * steps)`` steps (half to even) run CFG, the
          rest the conditional half only.  Both are opt-in approximations
          (None: the pipeline config's) and are not composed.
        * ``callback(i, t, latents)`` after every ``callback_steps``-th
          denoise step, with the latents on the device."""
        with self._top("request", views=True) as request:
            with tracing.span("inputs"):
                if output_type not in ("np", "pt", "float", "latent"):
                    raise ValueError(f"output_type must be 'np', 'pt', 'float' or 'latent', got {output_type!r}")
                if dispatch not in ("auto", "scan", "stepwise"):
                    raise ValueError(f"dispatch must be auto/scan/stepwise, got {dispatch!r}")
                if callback is not None:
                    if callback_steps < 1:
                        raise ValueError(f"callback_steps must be >= 1, got {callback_steps}")
                    if dispatch == "scan":
                        raise ValueError("per-step callback requires stepwise dispatch (the fused scan runs "
                                         "the whole clip as one device program); pass dispatch='stepwise' or 'auto'")
                if num_videos_per_prompt < 1:
                    raise ValueError(f"num_videos_per_prompt must be >= 1, got {num_videos_per_prompt}")
                pcfg = self.pipe_config
                encoder_cache = pcfg.encoder_cache if encoder_cache is None else encoder_cache
                cfg_cutoff = pcfg.cfg_cutoff if cfg_cutoff is None else cfg_cutoff
                if encoder_cache not in (1, 2):
                    raise ValueError(f"encoder_cache must be 1 (off) or 2, got {encoder_cache}")
                if not 0.0 <= cfg_cutoff <= 1.0:
                    raise ValueError(f"cfg_cutoff must be in [0, 1], got {cfg_cutoff}")
                num_frames = num_frames or pcfg.num_frames
                height = height or pcfg.height
                width = width or pcfg.width
                steps = num_inference_steps or pcfg.num_inference_steps
                guidance = guidance_scale if guidance_scale is not None else pcfg.guidance_scale
                strength = (
                    frame_similarity_sample_ratio if frame_similarity_sample_ratio is not None
                    else pcfg.frame_similarity_sample_ratio
                )
                prompts = [prompt] if isinstance(prompt, str) else list(prompt)
                use_cfg = guidance > 1.0
                has_condition = condition_image is not None
                if negative_prompt is None:
                    negatives = [""] * len(prompts)
                elif isinstance(negative_prompt, str):
                    negatives = [negative_prompt] * len(prompts)
                else:
                    negatives = list(negative_prompt)
                # interleaved ([p0, p0, p1, p1] for N = 2), as the reference repeats
                n = num_videos_per_prompt
                prompts = [p for p in prompts for _ in range(n)]
                negatives = [p for p in negatives for _ in range(n)]
                batch = len(prompts)
                if not use_cfg:
                    cfg_cutoff = 1.0  # guidance already off: nothing to cut
                if encoder_cache > 1 and cfg_cutoff < 1.0:
                    raise ValueError(
                        "cfg_cutoff and encoder_cache are separate content-level approximations and are "
                        "not composed (the turbo step pair would need cond-only full/cached variants); pick one")

                evals = batch * num_frames * (2 if use_cfg else 1)
                # temporal tiling holds one anchored window of frames at a time
                motion_cap = self.config.unet.motion_max_seq_length
                window = min(pcfg.temporal_window, motion_cap - 1) if num_frames > motion_cap else None
                concurrent_evals = evals if window is None else batch * (window + 1) * (2 if use_cfg else 1)
                sf = self.config.vae.spatial_scale_factor
                lh, lw = height // sf, width // sf
                tokens = lh * lw
                if unet_chunk == 0:
                    unet_chunk = 2 if evals * tokens >= self.UNET_CHUNK_AUTO_EVAL_TOKENS else 1
                if decode_slice == 0 and batch * num_frames > 64:
                    decode_slice = 32
                if decode_slice == 0 and tokens > 4096 and batch * num_frames > 8:
                    decode_slice = 2
                frames = batch * num_frames
                frames = decode_slice if 0 < decode_slice < frames and not vae_tiling else frames
                # decode_tiled's tiles are at most 64 latents a side
                decode_tokens = frames * (min(lh, 64) * min(lw, 64) if vae_tiling else tokens)
                if not memory_unsafe:
                    self._check_memory_envelope(concurrent_evals, height, width, batch)
                    if encoder_cache > 1:
                        self._check_encoder_cache_budget(num_frames, height, width, batch, use_cfg, window)
                    if output_type != "latent":
                        self._check_decode_envelope(frames, decode_tokens // frames)
                dispatch = self._resolve_dispatch(dispatch, callback, steps, batch, num_frames, window, use_cfg, tokens)
                init_latents = None
                if latents is not None and not has_condition:
                    lat_shape = (batch, num_frames, height // sf, width // sf, self.config.unet.in_channels)
                    init_latents = np.asarray(latents, dtype=np.float32)
                    if init_latents.shape != lat_shape:
                        raise ValueError(f"latents shape {init_latents.shape} != expected {lat_shape}")

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

                parts = self._build_parts(
                    batch, num_frames, height, width, steps, float(strength), float(guidance),
                    use_cfg, has_condition, decode_slice, vae_tiling, unet_chunk,
                )
                prep_fn, decode_fn, ts = parts[0], parts[2], parts[3]
                self.prepare_int8()  # a no-op unless a weight changed since the last call
                n_cfg = cfg_steps(cfg_cutoff, len(ts))
                # the kept step graphs: dropped if the UNet's weights changed, trimmed
                # to what this request leaves beside its denoise and its decode
                cache_bytes = self._encoder_cache_bytes(num_frames, height, width, batch, use_cfg, window)[1] \
                    if encoder_cache > 1 else 0
                beside_denoise, beside_decode = self._graph_rooms(
                    concurrent_evals * tokens, cache_bytes, 0 if output_type == "latent" else decode_tokens)
                key = None
                if dispatch == "scan":
                    if self._graph_weights_changed():
                        self.release_graphs()
                    # the bucket: what the step programs bake in as Python values
                    # (steps and strength are not among them: t and t_prev are
                    # device scalars), and the order the kinds are captured in
                    # (pooled graphs replay in capture order)
                    kinds = tuple(dict.fromkeys(step_kinds(len(ts), encoder_cache, n_cfg)))
                    key = (batch, num_frames, height, width, float(guidance), use_cfg, has_condition, unet_chunk,
                           encoder_cache, kinds, self.config, self.pipe_config,
                           None if getattr(self, "mesh", None) is None else self.mesh.key())
                    if 2 * concurrent_evals * tokens * self.EVAL_TOKEN_BYTES > beside_decode:
                        key = None  # its pool would not fit beside its decode: captured for this call only
                self._trim_graphs(beside_denoise, spare=key)
                gen = torch.Generator(device=self.device).manual_seed(int(seed))
                request.attrs["dispatch"] = dispatch
                self._sync()
            with tracing.span("prep"):
                latents, consts = prep_fn(text_ids, cond, clip_img, gen, init_latents=init_latents)
                self._sync()
            if dispatch == "scan":
                latents = self._denoise_scan(parts, consts, latents, encoder_cache, n_cfg, gen, keep=key,
                                             room=beside_decode, views=False)
            else:
                latents = self._denoise(parts, consts, latents, encoder_cache, n_cfg, gen, callback,
                                        callback_steps, views=False)
            out = latents
            if output_type != "latent":
                with tracing.span("decode", counters=("alloc",)):
                    out = decode_fn(consts, latents)
                    self._sync()
            with tracing.span("finish"):
                if output_type == "latent" and has_condition:
                    out = latents.clone()
                    out[:, 0] = consts[0].to(out.dtype)
                out = out.float().cpu().numpy()
                if not np.isfinite(out).all():
                    raise FloatingPointError(
                        f"generated {'latents' if output_type == 'latent' else 'video'} contain non-finite "
                        "values; with the static-offset flash softmax retry with "
                        "VideoUNetConfig.flash_static_max=0.0")
                return image_utils.postprocess_video(out) if output_type == "np" else out
