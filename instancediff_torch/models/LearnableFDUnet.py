"""Alias module: the reference config names the single-score-map UNet
``modules.LearnableFDUnet.LearnableForwardUNet``; it lives in ``unet.py``."""

from .unet import LearnableForwardUNet  # noqa: F401
