"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no GPU is present.

    Entry points default to ``"cuda"``; on a machine without a GPU they raise
    here instead of running on the CPU unasked.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
