from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import I2VAdapterPipeline
from i2v_adapter_tpu_torch.pipelines.svd_pipeline import StableVideoDiffusionPipeline

__all__ = ["I2VAdapterPipeline", "StableVideoDiffusionPipeline"]
