"""Where the port's tensors live: the card, unless the caller asks for the
CPU. The scene and camera entry points take `device="cuda"` by default and
raise when no CUDA device is present; they never fall back to the CPU. A
CPU run (the plain twins of the kernels) passes `device="cpu"`."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={str(device)!r}: the port runs on the "
            "card by default; pass device='cpu' to run the plain kernel twins "
            "on the CPU")
    return dev
