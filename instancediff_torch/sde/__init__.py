from .drift_sde import DriftSDE
from .schedules import make_schedule, strided_sampling_grid

__all__ = ["DriftSDE", "make_schedule", "strided_sampling_grid"]
