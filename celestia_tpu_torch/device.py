"""Device resolution for every entry point of the port.

``None`` means the GPU. An entry never falls back to the CPU on its own: the
CPU is used only when the caller passes ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
