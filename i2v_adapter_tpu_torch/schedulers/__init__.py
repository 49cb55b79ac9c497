from i2v_adapter_tpu_torch.schedulers.ddim import (
    ddim_schedule_arrays,
    ddim_step,
    ddim_timesteps,
    truncate_timesteps,
)
from i2v_adapter_tpu_torch.schedulers.ddpm import ddpm_step
from i2v_adapter_tpu_torch.schedulers.euler import euler_sigmas, euler_step, init_noise_sigma, scale_model_input
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
    "euler_sigmas",
    "euler_step",
    "get_velocity",
    "init_noise_sigma",
    "make_schedule",
    "scale_model_input",
    "truncate_timesteps",
]
