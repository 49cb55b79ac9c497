from i2v_adapter_tpu_torch.schedulers.ddim import (
    ddim_schedule_arrays,
    ddim_step,
    ddim_timesteps,
    truncate_timesteps,
)
from i2v_adapter_tpu_torch.schedulers.ddpm import ddpm_step
from i2v_adapter_tpu_torch.schedulers.schedule import (
    NoiseSchedule,
    add_noise,
    compute_snr,
    get_velocity,
    make_schedule,
)

__all__ = [
    "NoiseSchedule",
    "add_noise",
    "compute_snr",
    "ddim_schedule_arrays",
    "ddim_step",
    "ddim_timesteps",
    "ddpm_step",
    "get_velocity",
    "make_schedule",
    "truncate_timesteps",
]
