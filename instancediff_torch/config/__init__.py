"""YAML option helpers (port of ``instancediff_tpu/config``)."""

from .options import (NoneDict, check_resume, dict2str, dict_to_nonedict, load_options,
                      ordered_yaml, parse)

__all__ = ["NoneDict", "check_resume", "dict2str", "dict_to_nonedict", "load_options",
           "ordered_yaml", "parse"]
