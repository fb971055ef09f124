"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. A CUDA request without a card raises:
    the port never falls back to the CPU on its own; pass
    ``device="cpu"`` to run the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
