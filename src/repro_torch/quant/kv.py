"""int8 KV-cache quantization: per-(position, kv head) symmetric scales.

Port of ``repro/quant/kv.py``. The cache grows two fp32 scale planes next
to the int8 K/V buffers:

    k: (B, L, Hkv, D) int8        k_scale: (B, L, Hkv) fp32
    v: (B, L, Hkv, D) int8        v_scale: (B, L, Hkv) fp32

One scale per written (position, head) vector, computed at write time from
that vector's absmax, so storing a new token never rescales old entries.
Empty positions hold zero payload and zero scale; the ``pos = -1``
sentinel masks them in attention exactly as in the float cache. Nothing
here reads a tensor on the host, so a decode loop stays free of syncs.
"""
from __future__ import annotations

import torch

KV_QUANT_MODES = (None, "int8")


def validate_kv_quant(kv_quant) -> None:
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"kv_quant must be one of {KV_QUANT_MODES}, got {kv_quant!r}")


def quantize_kv(x):
    """x: (..., D) float -> (int8 (..., D), fp32 scale (...,)). Symmetric
    absmax/127 per trailing vector, rounded half to even (as
    ``jnp.round``) and clipped to +-127; an all-zero vector quantizes to
    exact zeros with scale 0."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xf / safe[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """Invert ``quantize_kv`` at read time (the attention read path)."""
    return (q.float() * scale[..., None]).to(dtype)
