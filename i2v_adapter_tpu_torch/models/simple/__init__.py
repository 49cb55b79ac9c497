"""The from-scratch latent-diffusion model zoo (the JAX package's
``models/simple``): SimpleUNet, SimpleUNet3D and the dome UNet."""

from i2v_adapter_tpu_torch.models.simple.blocks import (
    AlphaBlender,
    BasicAttention,
    BasicTransformerBlock,
    ResBlock,
    VideoResBlock,
    VideoTransformer,
    positional_emb,
)
from i2v_adapter_tpu_torch.models.simple.unet2d import SimpleUNet
from i2v_adapter_tpu_torch.models.simple.unet3d import SimpleUNet3D
from i2v_adapter_tpu_torch.models.simple.unet_dome import SimpleUNetDome

__all__ = [
    "AlphaBlender",
    "BasicAttention",
    "BasicTransformerBlock",
    "ResBlock",
    "VideoResBlock",
    "VideoTransformer",
    "positional_emb",
    "SimpleUNet",
    "SimpleUNet3D",
    "SimpleUNetDome",
]
