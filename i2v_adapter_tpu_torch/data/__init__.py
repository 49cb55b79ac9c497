"""Host data path of the training driver: the WebVid clip dataset, its
threaded loader and the native preprocessing library (``native``)."""

from i2v_adapter_tpu_torch.data.loader import DataLoader
from i2v_adapter_tpu_torch.data.webvid import WebVidDataset

__all__ = ["DataLoader", "WebVidDataset"]
