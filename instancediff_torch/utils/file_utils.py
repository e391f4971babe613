"""Filesystem, logging and seeding helpers of the training driver (port of
``mkdirs``, ``mkdir_and_rename``, ``setup_logger``, ``store_files`` and
``set_random_seed`` in ``instancediff_tpu/utils/file_utils.py``)."""

from __future__ import annotations

import logging
import os
import random
import shutil
import sys
from datetime import datetime

import numpy as np
import torch


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdirs(paths) -> None:
    for p in [paths] if isinstance(paths, str) else paths:
        os.makedirs(p, exist_ok=True)


def mkdir_and_rename(path: str) -> None:
    """Create ``path``; an existing one is first archived under a timestamped
    name."""
    if os.path.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        print(f"Path already exists. Rename it to [{new_name}]")
        os.rename(path, new_name)
    os.makedirs(path)


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators. The train step
    draws from explicit ``torch.Generator``s; this covers the rest."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_logger(logger_name: str, root: str, phase: str, level=logging.INFO,
                 screen: bool = False, tofile: bool = False) -> logging.Logger:
    """A named logger writing ``<phase>_<timestamp>.log`` under ``root``
    and/or to stdout."""
    lg = logging.getLogger(logger_name)
    formatter = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                                  datefmt="%y-%m-%d %H:%M:%S")
    lg.setLevel(level)
    if tofile:
        fh = logging.FileHandler(os.path.join(root, f"{phase}_{get_timestamp()}.log"), mode="w")
        fh.setFormatter(formatter)
        lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg


def store_files(opt, dst_dir: str) -> None:
    """Copy the config's ``file_to_be_store`` files into the experiment."""
    os.makedirs(dst_dir, exist_ok=True)
    for f in opt.get("file_to_be_store") or []:
        if os.path.isfile(f):
            shutil.copy(f, os.path.join(dst_dir, os.path.basename(f)))
