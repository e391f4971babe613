from .ddpm_sde import DDPMSDE, make_cosine_alphas_bar
from .drift_sde import DriftSDE
from .schedules import make_schedule, strided_sampling_grid

__all__ = ["DDPMSDE", "DriftSDE", "make_cosine_alphas_bar", "make_schedule",
           "strided_sampling_grid"]
