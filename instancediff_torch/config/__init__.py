"""YAML option helpers (port of ``instancediff_tpu/config``)."""

from .options import NoneDict, dict_to_nonedict, load_options, ordered_yaml

__all__ = ["NoneDict", "dict_to_nonedict", "load_options", "ordered_yaml"]
