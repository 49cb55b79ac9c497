from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import I2VAdapterPipeline

__all__ = ["I2VAdapterPipeline"]
