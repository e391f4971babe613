"""The name the configurations give the drift engine's module
(``module_name: drift_noise_model``, ``class_name: CLIPDriftModel``)."""

from .drift_model import CLIPDriftEngine as CLIPDriftModel  # noqa: F401
from .drift_model import create_CLIPDriftModel  # noqa: F401
