"""Host utilities: weight bundles and their msgpack codec, parameter
conversion, metrics, image input and output, files, logging and tracing."""

from .file_utils import (
    get_timestamp,
    mkdir,
    mkdirs,
    mkdir_and_rename,
    set_random_seed,
    setup_logger,
    store_files,
    ProgressBar,
)
from .img_utils import tensor2img, img2tensor, save_img, save_raw, load_raw
from .metrics import calculate_psnr, calculate_ssim, calculate_rmse

__all__ = [
    "get_timestamp",
    "mkdir",
    "mkdirs",
    "mkdir_and_rename",
    "set_random_seed",
    "setup_logger",
    "store_files",
    "ProgressBar",
    "tensor2img",
    "img2tensor",
    "save_img",
    "save_raw",
    "load_raw",
    "calculate_psnr",
    "calculate_ssim",
    "calculate_rmse",
]
