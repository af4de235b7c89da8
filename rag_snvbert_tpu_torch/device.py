"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU: with
no device given they take ``cuda`` and raise when no card is present.
They never drop quietly to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as given, and a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
