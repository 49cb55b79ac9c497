"""Typed configuration tree of the PyTorch port.

The port keeps its own copy of the frozen dataclass tree of the JAX package
(same fields, defaults and validation), so that it depends on nothing of
that package.  Every config is hashable and round-trips through JSON.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


class _ConfigBase:
    """JSON round-tripping shared by every config dataclass."""

    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), indent=2, **kwargs)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]):
        import typing

        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            value = data[f.name]
            ftype = hints.get(f.name, f.type)
            if dataclasses.is_dataclass(ftype) and isinstance(value, Mapping):
                value = ftype.from_dict(value)
            elif isinstance(value, list):
                value = tuple(value)
            kwargs[f.name] = value
        return cls(**kwargs)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class VideoUNetConfig(_ConfigBase):
    """Motion + cross-frame-attention video UNet; defaults are SD1.5."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    # True => the block at that depth carries spatial transformers
    # (self-attn + cross-frame adapter + text/IP cross-attn).
    down_block_has_attention: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attention: Tuple[bool, ...] = (False, True, True, True)
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    act_fn: str = "silu"
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    num_attention_heads: int = 8
    use_linear_projection: bool = False
    transformer_layers_per_block: int = 1
    # AnimateDiff-style temporal motion modules.
    use_motion_modules: bool = True
    motion_max_seq_length: int = 32
    motion_num_attention_heads: int = 8
    use_motion_mid_block: bool = True
    # I2V-Adapter cross-frame attention.
    use_i2v_adapter: bool = True
    # IP-Adapter image-conditioning branch.
    use_ip_adapter: bool = True
    ip_variant: str = "standard"  # 'standard' | 'plus' | 'full_face'
    ip_num_tokens: int = 4
    image_embed_dim: int = 1024
    ip_hidden_dim: int = 1280
    ip_resampler_dim: int = 768
    ip_resampler_depth: int = 4
    ip_resampler_heads: int = 12
    ip_scale: float = 1.0
    # FreeU skip re-weighting (s1, s2, b1, b2); None = off.
    freeu: Optional[Tuple[float, float, float, float]] = None
    # Activation checkpointing of heavy blocks (training).
    remat: bool = False
    # True routes long-sequence attention through the flash kernel.
    flash_attention: bool = True
    # Log2-space softmax offset of the flash kernel in place of the per-row
    # running max.  Exact for raw logits in about (-48, +132); rows whose
    # logits all fall below that go NaN.  0.0 keeps the exact running max.
    flash_static_max: float = 64.0
    # tanh-approximate gelu in the GEGLU feed-forwards.
    fast_gelu: bool = True
    # int8 3x3 resnet convs (serving-mode numerics).
    int8_conv: bool = False
    # Resnet 3x3 conv lowering: 'auto' (= plain conv) | 'pallas' | 'xla'.
    conv_impl: str = "auto"

    def __post_init__(self):
        if len(self.down_block_has_attention) != len(self.block_out_channels):
            raise ValueError(
                "down_block_has_attention must match block_out_channels: "
                f"{self.down_block_has_attention} vs {self.block_out_channels}"
            )
        if len(self.up_block_has_attention) != len(self.block_out_channels):
            raise ValueError(
                "up_block_has_attention must match block_out_channels: "
                f"{self.up_block_has_attention} vs {self.block_out_channels}"
            )
        if self.ip_variant not in ("standard", "plus", "full_face"):
            raise ValueError(f"unknown ip_variant: {self.ip_variant}")

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclass(frozen=True)
class VAEConfig(_ConfigBase):
    """SD AutoencoderKL shape (SD1.5 defaults)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    act_fn: str = "silu"
    scaling_factor: float = 0.18215
    sample_size: int = 512
    # Serving-mode int8 decoder convs.
    int8_decode: bool = False

    @property
    def spatial_scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass(frozen=True)
class CLIPTextConfig(_ConfigBase):
    """SD1.5 text encoder (CLIP ViT-L/14) shape."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768


@dataclass(frozen=True)
class CLIPVisionConfig(_ConfigBase):
    """IP-Adapter image encoder (OpenCLIP ViT-H/14) shape."""

    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    projection_dim: int = 1024


@dataclass(frozen=True)
class SchedulerConfig(_ConfigBase):
    """Shared DDPM/DDIM noise-schedule description (SD1.5 values)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear"
    prediction_type: str = "epsilon"  # or "v_prediction"
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    timestep_spacing: str = "linspace"  # "linspace" | "leading" | "trailing"


@dataclass(frozen=True)
class PipelineConfig(_ConfigBase):
    """Inference hyperparameters."""

    num_frames: int = 16
    height: int = 512
    width: int = 512
    num_inference_steps: int = 25
    guidance_scale: float = 7.5
    # PIA-style first-frame similarity prior.
    frame_similarity_sample_ratio: float = 0.9
    frame_similarity_blurred_strength: float = 0.6
    blur_kernel_size: int = 3
    # None => sigma ~ U(0.1, 2.0) per call; a fixed value is deterministic.
    blur_sigma: Optional[float] = None
    eta: float = 0.0
    dtype: str = "bfloat16"
    # Serving-mode int8 convs (UNet 3x3s + VAE decoder), through ops/int8.py.
    int8_conv: bool = True
    # Opt-in serving approximations (off by default): 2 reuses the UNet's
    # down-path features every second step; < 1.0 runs the trailing steps
    # on the conditional branch only.
    encoder_cache: int = 1
    cfg_cutoff: float = 1.0
    # Temporal tiling of clips longer than motion_max_seq_length.
    temporal_window: int = 16
    temporal_stride: int = 12

    def __post_init__(self):
        if not (0.0 < self.frame_similarity_sample_ratio <= 1.0):
            raise ValueError(
                "frame_similarity_sample_ratio must be in (0, 1], got "
                f"{self.frame_similarity_sample_ratio}"
            )
        if not (0.0 <= self.cfg_cutoff <= 1.0):
            raise ValueError(
                f"cfg_cutoff must be in [0, 1], got {self.cfg_cutoff}"
            )


@dataclass(frozen=True)
class MeshConfig(_ConfigBase):
    """Device mesh layout of the JAX package (axis sizes, -1 = the rest).
    Serving takes any layout (``parallel.mesh.create_mesh``, ``--mesh``);
    training over a mesh is not ported, so ``TrainConfig`` accepts only the
    default."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1


@dataclass(frozen=True)
class OptimizerConfig(_ConfigBase):
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"  # constant|linear|cosine|constant_with_warmup
    lr_warmup_steps: int = 500
    # 'adamw' or 'adafactor'
    optimizer: str = "adamw"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    scale_lr: bool = False

    def __post_init__(self):
        if self.optimizer not in ("adamw", "adafactor"):
            raise ValueError(f"unknown optimizer: {self.optimizer}")


@dataclass(frozen=True)
class TrainConfig(_ConfigBase):
    """Training hyperparameters (same fields and defaults as the JAX
    package's ``TrainConfig``)."""

    # 'i2v': adapter (+ motion) finetune on clips; 't2i': whole-UNet
    # single-frame finetune.
    train_mode: str = "i2v"
    resolution: int = 256
    num_frames: int = 16
    sample_stride: int = 4
    train_batch_size: int = 8
    gradient_accumulation_steps: int = 4
    num_train_epochs: int = 10
    max_train_steps: Optional[int] = None
    seed: int = 0
    # adapter to_q/to_out always train; motion modules only when set
    update_motion_modules: bool = False
    snr_gamma: Optional[float] = None
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    prediction_type: Optional[str] = None
    # classifier-free-guidance condition dropout probabilities
    uncond_prob_t: float = 0.0
    uncond_prob_i: float = 0.0
    uncond_prob_ti: float = 0.0
    # 'scaled' keeps sqrt(abar) x0 in frame 0; 'exact' restores the clean frame
    first_frame_mode: str = "scaled"
    gradient_checkpointing: bool = False
    # VAE-encode the batch this many frames at a time (0 = all at once)
    vae_encode_slice: int = 0
    mixed_precision: str = "bfloat16"  # "none" | "bfloat16"
    # storage dtype of the frozen weights; trainables stay fp32
    freeze_dtype: str = "float32"  # "float32" | "bfloat16"
    use_ema: bool = False
    ema_decay: float = 0.9999
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    fsdp_frozen: str = "shard"  # "shard" | "replicate"
    checkpoint_epoch: int = 2
    checkpoints_total_limit: Optional[int] = None

    def __post_init__(self):
        if self.train_mode not in ("i2v", "t2i"):
            raise ValueError(f"bad train_mode: {self.train_mode}")
        if self.fsdp_frozen not in ("shard", "replicate"):
            raise ValueError(f"bad fsdp_frozen: {self.fsdp_frozen}")
        if self.first_frame_mode not in ("scaled", "exact"):
            raise ValueError(f"bad first_frame_mode: {self.first_frame_mode}")
        total = self.uncond_prob_t + self.uncond_prob_i + self.uncond_prob_ti
        if total > 1.0:
            raise ValueError(f"uncond probabilities sum to {total} > 1")
        if self.mesh != MeshConfig():
            raise NotImplementedError(
                f"not ported yet: mesh={self.mesh} (ROADMAP: multi-GPU training)"
            )


@dataclass(frozen=True)
class I2VModelConfig(_ConfigBase):
    unet: VideoUNetConfig = field(default_factory=VideoUNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    text_encoder: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    image_encoder: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


def reference_train_config() -> TrainConfig:
    """The reference training workload (the JAX bench's config 4): 2 clips
    x 16 frames at 256 px, bf16 compute with fp32 trainables, frozen weights
    stored in bf16, activation checkpointing, AdamW, no accumulation."""
    return TrainConfig(train_batch_size=2, num_frames=16, resolution=256,
                       gradient_accumulation_steps=1, mixed_precision="bfloat16",
                       gradient_checkpointing=True, freeze_dtype="bfloat16")


def tiny_test_config() -> I2VModelConfig:
    """A miniature model for unit tests (seconds on a CPU)."""
    return I2VModelConfig(
        unet=VideoUNetConfig(
            sample_size=8,
            down_block_has_attention=(True, False),
            up_block_has_attention=(False, True),
            block_out_channels=(32, 64),
            layers_per_block=1,
            cross_attention_dim=16,
            num_attention_heads=2,
            motion_num_attention_heads=2,
            motion_max_seq_length=8,
            image_embed_dim=8,
            norm_num_groups=8,
            fast_gelu=False,
        ),
        vae=VAEConfig(
            block_out_channels=(16, 32),
            layers_per_block=1,
            norm_num_groups=8,
            sample_size=32,
        ),
        text_encoder=CLIPTextConfig(
            vocab_size=1000,
            hidden_size=16,
            intermediate_size=32,
            num_hidden_layers=2,
            num_attention_heads=2,
            max_position_embeddings=16,
        ),
        image_encoder=CLIPVisionConfig(
            hidden_size=16,
            intermediate_size=32,
            num_hidden_layers=2,
            num_attention_heads=2,
            image_size=28,
            patch_size=14,
            projection_dim=8,
        ),
    )
