"""Filesystem, logging, progress and seeding helpers of the drivers (port of
``mkdir``, ``mkdirs``, ``mkdir_and_rename``, ``setup_logger``,
``ProgressBar``, ``store_files`` and ``set_random_seed`` in
``instancediff_tpu/utils/file_utils.py``)."""

from __future__ import annotations

import logging
import os
import random
import shutil
import sys
import time
from datetime import datetime

import numpy as np
import torch


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def mkdirs(paths) -> None:
    for p in [paths] if isinstance(paths, str) else paths:
        mkdir(p)


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


class ProgressBar:
    """A console progress bar on stdout: a ``bar_width``-wide bar (2 to 50)
    with tasks per second, elapsed time and ETA, redrawn in place; a plain
    counter when ``task_num`` is 0."""

    def __init__(self, task_num: int = 0, bar_width: int = 50, start: bool = True):
        self.task_num = task_num
        self.bar_width = max(2, min(bar_width, 50))
        self.completed = 0
        if start:
            self.start()

    def start(self) -> None:
        if self.task_num > 0:
            sys.stdout.write(f"[{' ' * self.bar_width}] 0/{self.task_num}, elapsed: 0s, ETA:\n")
        else:
            sys.stdout.write("completed: 0, elapsed: 0s")
        sys.stdout.flush()
        self.start_time = time.time()

    def update(self, msg: str = "In progress...") -> None:
        self.completed += 1
        elapsed = max(time.time() - self.start_time, 1e-9)
        fps = self.completed / elapsed
        if self.task_num > 0:
            percentage = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - percentage) / max(percentage, 1e-9) + 0.5)
            mark_width = int(self.bar_width * percentage)
            bar = ">" * mark_width + "-" * (self.bar_width - mark_width)
            sys.stdout.write("\033[2F\033[J")
            sys.stdout.write(f"[{bar}] {self.completed}/{self.task_num}, "
                             f"{fps:.1f} task/s, elapsed: {int(elapsed + 0.5)}s, "
                             f"ETA: {eta:5}s\n{msg}\n")
        else:
            sys.stdout.write(f"completed: {self.completed}, elapsed: {int(elapsed + 0.5)}s,"
                             f" {fps:.1f} tasks/s")
        sys.stdout.flush()


def store_files(opt, dst_dir: str) -> None:
    """Copy the config's ``file_to_be_store`` files into the experiment."""
    os.makedirs(dst_dir, exist_ok=True)
    for f in opt.get("file_to_be_store") or []:
        if os.path.isfile(f):
            shutil.copy(f, os.path.join(dst_dir, os.path.basename(f)))
