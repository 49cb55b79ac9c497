from i2v_adapter_tpu_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from i2v_adapter_tpu_torch.models.svd import AutoencoderKLTemporalDecoder, SpatioTemporalUNet
from i2v_adapter_tpu_torch.models.unet_video import VideoUNet
from i2v_adapter_tpu_torch.models.vae import AutoencoderKL

__all__ = ["AutoencoderKL", "AutoencoderKLTemporalDecoder", "CLIPTextEncoder", "CLIPVisionEncoder",
           "SpatioTemporalUNet", "VideoUNet"]
