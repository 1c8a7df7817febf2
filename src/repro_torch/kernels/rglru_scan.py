"""K5: the RG-LRU linear scan, h_t = a_t * h_{t-1} + b_t from h = 0.

Port of the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``rglru_scan``). On a CUDA tensor ``rglru_scan`` launches the
hand-written Hopper kernel in ``csrc/rglru_scan.cu``; on a CPU tensor it
runs ``rglru_scan_plain``, a sequential loop over t in PyTorch (the
function of ``repro/kernels/ref.py:rglru_scan_ref``). There is no fallback
between the two: a CUDA tensor launches the kernel or raises.

Both take a and b as (B, S, W) fp32 and return h (B, S, W) fp32. The TPU
wrapper pads S to a whole seq block with the identity (a = 1, b = 0); the
Hopper kernel needs no padding. What bounds the kernel on the card, and
what its design does about it, is set out at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _check(a, b):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one (B, S, W) shape")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the scan takes float32 a and b, got {a.dtype} / "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    if min(a.shape) < 1:
        raise ValueError(f"empty scan {tuple(a.shape)}")


def rglru_scan_plain(a, b):
    """The recurrence in PyTorch, one step per t: h = a[:, t] * h + b[:, t]
    from h = 0 (a product, then a sum: two roundings)."""
    _check(a, b)
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def _lib():
    lib = build.load("rglru_scan")
    fn = lib.rglru_scan
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.restype = i
        fn.argtypes = [p, p, p, i, i, i, p]
    return lib


def rglru_scan(a, b):
    """a, b: (B, S, W) float32 -> h (B, S, W) float32.

    A CPU tensor runs ``rglru_scan_plain``. A CUDA tensor launches the
    kernel (on contiguous copies where a or b is strided) and adds one to
    ``rglru_scan.launches``."""
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cpu or cuda, not {a.device}")
    _check(a, b)
    a, b = a.contiguous(), b.contiguous()
    B, S, W = a.shape
    h = torch.empty_like(a)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S,
                            W, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{rc}")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
