"""Host data path of the trainers: the WebVid clip dataset, its threaded
loader and the native preprocessing library (``native``) of the training
driver; the pre-encoded latent datasets of the latent trainers."""

from i2v_adapter_tpu_torch.data.latent import ImageFolderDataset, LatentImageDataset, LatentVideoDataset
from i2v_adapter_tpu_torch.data.loader import DataLoader
from i2v_adapter_tpu_torch.data.webvid import WebVidDataset

__all__ = [
    "DataLoader",
    "ImageFolderDataset",
    "LatentImageDataset",
    "LatentVideoDataset",
    "WebVidDataset",
]
