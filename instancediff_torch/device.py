"""Device resolution shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise when CUDA is asked for but absent.

    Nothing falls back to the CPU on its own: a caller that wants the plain
    PyTorch path passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "instancediff_torch: device 'cuda' requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
