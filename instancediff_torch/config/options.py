"""YAML options with the reference schema (port of
``instancediff_tpu/config/options.py``: ``ordered_yaml``, ``NoneDict``,
``dict_to_nonedict``, ``parse``, ``check_resume`` and ``dict2str``)."""

from __future__ import annotations

import logging
import os
import os.path as osp
from collections import OrderedDict

import yaml

logger = logging.getLogger("instancediff_torch")


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


def _sniff_data_type(dataroot) -> str:
    if dataroot is None:
        return "img"
    if dataroot.endswith(".lmdb"):
        return "lmdb"
    if dataroot.startswith("mc:"):
        return "mc"
    return "img"


def parse(opt_path: str, is_train: bool = True):
    """An experiment YAML with its runtime fields: each dataset's ``phase``,
    ``scale`` and ``data_type``; root paths expanded; for training the
    experiment's directories under ``path.root`` (default the working
    directory) ``/experiments/<name>`` (``models``, ``training_state``,
    ``val_images``, the log), with the debug cadences when the name holds
    "debug"; for testing ``results/<name>``. ``gpu_ids`` only informs
    ``n_devices``."""
    loader, _ = ordered_yaml()
    with open(opt_path, mode="r") as f:
        opt = yaml.load(f, Loader=loader)

    opt["is_train"] = is_train
    ids = opt.get("gpu_ids") or []
    opt["n_devices"] = max(1, len(ids)) if isinstance(ids, (list, tuple)) else 1
    scale = opt.get("degradation", {}).get("scale", 1) if opt.get("degradation") else 1
    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        dataset["scale"] = scale
        if dataset.get("dataroot") is not None:
            dataset["dataroot"] = osp.expanduser(dataset["dataroot"])
        dataset["data_type"] = _sniff_data_type(dataset.get("dataroot"))

    for key, path in (opt.get("path") or {}).items():
        if path and "root" in key:
            opt["path"][key] = osp.abspath(osp.expanduser(path))
    if opt.get("path") is None:
        opt["path"] = {}
    opt["path"]["root"] = osp.abspath(osp.expanduser(opt["path"].get("root", os.getcwd())))

    if is_train:
        experiments_root = osp.join(opt["path"]["root"], "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_state"] = osp.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = osp.join(experiments_root, "val_images")
        if "debug" in opt["name"]:
            train = opt.get("train") or {}
            train["val_freq"] = 8
            logger_opt = opt.get("logger") or {}
            logger_opt["print_freq"] = 2
            logger_opt["save_checkpoint_freq"] = 8
            opt["train"] = train
            opt["logger"] = logger_opt
    else:
        results_root = osp.join(opt["path"]["root"], "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
    return opt


def check_resume(opt, resume_iter):
    """With ``path.resume_state`` set, point ``path.pretrain_model_{DN,NN,DP,NP}``
    (and the schema's ``pretrain_model_G``) at the resume iteration's bundle
    files under ``path.models``; explicit pretrain paths are ignored with a
    warning."""
    if opt["path"].get("resume_state"):
        if opt["path"].get("pretrain_model_G") or opt["path"].get("pretrain_model_D"):
            logger.warning("pretrain_model paths will be ignored during resume; "
                           "weights come from the resume iteration instead.")
        for tag in ("DN", "NN", "DP", "NP"):
            opt["path"][f"pretrain_model_{tag}"] = osp.join(
                opt["path"]["models"], f"{resume_iter}_{tag}.ckpt")
        opt["path"]["pretrain_model_G"] = opt["path"]["pretrain_model_DN"]
        logger.info("Set resume pretrain bundle to %s/%s_{DN,NN,DP,NP}.ckpt",
                    opt["path"]["models"], resume_iter)
    return opt


def dict2str(opt, indent_l: int = 1) -> str:
    """A nested option dict, one key per line, indented by depth."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg
