"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Imports ``torch`` and never ``jax`` or ``repro``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; asked for the card
without CUDA they raise (see ``resolve_device``).

Where CUDA is present, importing the package makes cublasLt PyTorch's
preferred BLAS library (``torch.backends.cuda.preferred_blas_library``,
process-wide), once, before any product runs. The serving engine pads a
prefill to at least 128 rows of M so that a row's bits do not follow the
batch it joins (``serving.engine.PREFILL_MIN_M``); on the H100 cuBLAS's
own heuristic splits a long contraction at M = 128 and not above it
(stablelm-12b's and gemma2-27b's ``w_down``, K = 13824 and 36864), while
cublasLt's keeps those rows' bits from 128 to 16384 rows, at the same
speed (``chip_blas_rows.py`` measures both).
"""
from __future__ import annotations

import torch

if torch.cuda.is_available():
    torch.backends.cuda.preferred_blas_library("cublaslt")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without CUDA raises: the port
    never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
