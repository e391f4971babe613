"""YAML options with the reference schema (port of ``ordered_yaml``,
``NoneDict`` and ``dict_to_nonedict`` in ``instancediff_tpu/config/options.py``;
``parse`` and ``check_resume`` come with training)."""

from __future__ import annotations

from collections import OrderedDict

import yaml


def ordered_yaml():
    """(Loader, Dumper) that keep mappings in file order."""
    try:
        from yaml import CDumper as Dumper
        from yaml import CLoader as Loader
    except ImportError:
        from yaml import Dumper, Loader

    tag = yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG

    def dict_representer(dumper, data):
        return dumper.represent_dict(data.items())

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Dumper.add_representer(OrderedDict, dict_representer)
    Loader.add_constructor(tag, dict_constructor)
    return Loader, Dumper


class NoneDict(dict):
    """A dict whose missing keys read as ``None``."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    """``opt`` with every dict, also inside lists and tuples, a ``NoneDict``."""
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, (list, tuple)):
        return type(opt)(dict_to_nonedict(v) for v in opt)
    return opt


def load_options(opt_path: str) -> NoneDict:
    """A YAML config as ``NoneDict``s (the raw load ``testUM.py`` and
    ``Restorer.from_config`` make; no ``parse``)."""
    loader, _ = ordered_yaml()
    with open(opt_path) as f:
        return dict_to_nonedict(yaml.load(f, Loader=loader))
