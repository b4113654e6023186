"""Device choice for the port's entry points.

Entry points take ``device="cuda"`` by default and never move to the CPU on
their own: without a card they raise, and the caller who wants the plain
PyTorch versions asks for ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was asked for but CUDA is not "
                           f"available; pass device='cpu' to run the plain "
                           f"PyTorch versions on the CPU")
    return dev
