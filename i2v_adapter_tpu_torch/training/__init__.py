from i2v_adapter_tpu_torch.training.checkpoint import (
    TrainCheckpointer,
    export_pipeline,
    find_latest_epoch,
    load_adapter_checkpoint,
    load_pipeline_params,
    save_adapter_checkpoint,
)
from i2v_adapter_tpu_torch.training.state import (
    Optimizer,
    OptState,
    TrainState,
    create_train_state,
    ema_update,
    make_lr_schedule,
    make_optimizer,
    partition_params,
    trainable_predicate,
)
from i2v_adapter_tpu_torch.training.train_i2v import diffusion_loss, make_train_step, sample_draws

__all__ = [
    "OptState",
    "Optimizer",
    "TrainCheckpointer",
    "TrainState",
    "create_train_state",
    "diffusion_loss",
    "ema_update",
    "export_pipeline",
    "find_latest_epoch",
    "load_adapter_checkpoint",
    "load_pipeline_params",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "partition_params",
    "sample_draws",
    "save_adapter_checkpoint",
    "trainable_predicate",
]
