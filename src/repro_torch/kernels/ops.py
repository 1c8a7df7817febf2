"""Public wrappers around the kernels: tile-size choice and dispatch.

``mha_prefill`` is the port of ``repro/kernels/ops.py:mha_prefill``. The
TPU wrapper transposes q/k/v to (B*H, S, D) and pads them to whole tiles
before the kernel; the Hopper kernel reads (B, S, H, D) through strides and
masks the ragged edges itself, so here the wrapper only picks the tiles.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import BLOCK_K, flash_attention

H100_SMS = 132


def attn_block_sizes(kind: str, sq: int, *, bh: int = 1):
    """(bq, bk) for the attention kernel on an H100.

    bk is the CUDA kernel's one kv tile (BLOCK_K = 32: small enough that
    fp32 K and V tiles of head dim 128 fit 32 KB of shared memory, and
    that a sliding window's live span stays within a few tiles). bq is 64
    (256 threads a block) when that still gives every SM two blocks of the
    ``bh = B*Hq`` heads, else 32: short buckets waste fewer padded query
    rows and small batches fill more SMs. The heuristic is not yet tuned by
    measurement. (The TPU table also keys on skv and the window; here the
    one kv tile serves every shape.)"""
    if kind != "prefill":
        raise NotImplementedError(
            f"attention kind {kind!r}: the decode kernel (K2) is ROADMAP "
            f"Queue 1 item 5")
    bq = 64 if sq > 32 and bh * -(-sq // 64) >= 2 * H100_SMS else 32
    return bq, BLOCK_K


def mha_prefill(q, k, v, *, causal=True, window=None, softcap=None,
                kv_len=None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), at the
    tiles ``attn_block_sizes`` picks. ``kv_len`` (default Skv) masks kv
    columns at and beyond it."""
    B, Sq, Hq, _ = q.shape
    bq, bk = attn_block_sizes("prefill", Sq, bh=B * Hq)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, kv_len=kv_len, bq=bq, bk=bk)
