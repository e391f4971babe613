"""Alias module: the reference config names the multi-score-map UNet
``modules.MSM_degEmb_Unet.LearnableForwardUNet_MultiScoreMap``; it lives in
``unet.py``, its score map module in ``scoremap.py``."""

from .scoremap import ScoreMapModule  # noqa: F401
from .unet import (  # noqa: F401
    LearnableForwardUNetMultiScoreMap,
    LearnableForwardUNetMultiScoreMap as LearnableForwardUNet_MultiScoreMap,
)
