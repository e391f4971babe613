"""PyTorch + CUDA port of the InstanceDiff drift-diffusion restorer.

The package mirrors ``instancediff_tpu``'s layout (``sde/``, ``ops/``,
``models/``, ``serving.py``) so each module's JAX counterpart is found under
the same name. It imports torch and numpy only. Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise when CUDA is missing unless
the caller asks for ``device="cpu"``; on the CPU every hand-written kernel is
replaced by its plain PyTorch version (``ops/``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
