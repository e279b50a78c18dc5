"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card (``cuda``).  The CPU is used only when the
    caller asks for it; asking for CUDA without a card raises rather than
    falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def on_card(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper sends ``t`` to its CUDA kernel (True) or to
    its plain PyTorch version (False, a CPU tensor); any other device
    raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {t.device}")
