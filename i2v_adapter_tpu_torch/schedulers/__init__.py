from i2v_adapter_tpu_torch.schedulers.ddim import (
    ddim_schedule_arrays,
    ddim_step,
    ddim_timesteps,
    truncate_timesteps,
)
from i2v_adapter_tpu_torch.schedulers.schedule import NoiseSchedule, add_noise, make_schedule

__all__ = [
    "NoiseSchedule",
    "add_noise",
    "ddim_schedule_arrays",
    "ddim_step",
    "ddim_timesteps",
    "make_schedule",
    "truncate_timesteps",
]
