"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Imports ``torch`` and never ``jax`` or ``repro``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; asked for the card
without CUDA they raise (see ``resolve_device``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises: the port
    never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
