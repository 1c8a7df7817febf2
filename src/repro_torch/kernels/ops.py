"""Public wrappers around the kernels: tile-size choice and dispatch.

``mha_prefill``, ``gqa_decode``, ``matmul_q8``, ``matmul`` and
``lru_scan`` are the ports of the functions of those names in
``repro/kernels/ops.py``. The TPU wrappers transpose q/k/v to (B*H, S, D),
repeat kv_pos per kv head and pad to whole tiles (or seq blocks) before
the kernel; the Hopper kernels read (B, S, H, D), (B, L) and (M, K)
through strides and mask the ragged edges themselves, so here the
wrappers only pick the tiles (``matmul_plan`` for K3/K4).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import BLOCK_K as DECODE_BLOCK_K
from repro_torch.kernels.decode_attention import (H100_SMS, decode_attention,
                                                  decode_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 kernel_tiles)
from repro_torch.kernels.int8_matmul import (cache_matmul, int8_matmul,
                                             int8_matmul_plain, matmul_plan)
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain


def attn_block_sizes(kind: str, sq: int, *, bh: int = 1,
                     head_dim: int = 64, dtype=torch.float32):
    """(bq, bk) for the attention kernels on an H100.

    Prefill (K1): bk is the kernel's kv tile for ``dtype`` and
    ``head_dim`` (``flash_attention.kernel_tiles``): 32 rows in fp32 (the
    CUDA-core kernel, whose fp32 K and V tiles of head dim 256 fit 64 KB
    of shared memory), 64 in bf16 (the tensor-core kernel), 32 there at
    head dim 256. bq is the largest q tile K1 is built for (32, and 64
    except in fp32 at head dim 256) that still gives every SM two blocks
    of the ``bh = B*Hq`` heads and is not mostly padding for ``sq``,
    else 32: short buckets waste fewer padded query rows and small
    batches fill more SMs. (A pair K1 is not built for runs only on the
    CPU, where the plain version takes any tile.) Decode (K2): bq is 1 and bk the kernel's kv tile of 32 slots,
    one warp wide, so a short request in a long ring, or a window, pays
    only for its live tiles; the kernel is built for that one tile. The
    heuristic is not yet tuned by measurement. (The TPU table also keys
    on skv and the window.)
    Attention of a chunk of queries over a cache (chunked prefill, ROADMAP
    Queue 1 item 7) has no kernel yet."""
    if kind == "decode":
        return 1, DECODE_BLOCK_K
    if kind != "prefill":
        raise NotImplementedError(
            f"attention kind {kind!r}: chunked prefill over a cache is "
            f"ROADMAP Queue 1 item 7, speculative verify item 10")
    bqs, bk = kernel_tiles(dtype, head_dim)
    fits = [bq for bq in bqs
            if bq == 32 or sq > bq // 2 and bh * -(-sq // bq) >= 2 * H100_SMS]
    return max(fits), bk


def mha_prefill(q, k, v, *, causal=True, window=None, softcap=None,
                kv_len=None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), at the
    tiles ``attn_block_sizes`` picks. ``kv_len`` (default Skv) masks kv
    columns at and beyond it."""
    B, Sq, Hq, D = q.shape
    bq, bk = attn_block_sizes("prefill", Sq, bh=B * Hq, head_dim=D,
                              dtype=q.dtype)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, kv_len=kv_len, bq=bq, bk=bk)


def gqa_decode(q, k, v, q_pos, kv_pos, *, window=None, softcap=None,
               width=None):
    """q: (B, 1, Hq, D); k/v cache: (B, L, Hkv, D); q_pos: (B,); kv_pos:
    (B, L) int32 -> (B, 1, Hq, D), at K2's one kv tile (the ``bk`` of
    ``attn_block_sizes("decode", ...)``) and its split count
    (``decode_attention.decode_splits`` for ``width`` rows, default B).
    The split count sets the order of the fold, so a row's bits depend
    on it: a fixed ``width`` keeps them whatever B is."""
    n_split = (None if width is None else
               decode_splits(width, k.shape[2], k.shape[1])[0])
    return decode_attention(q, k, v, q_pos, kv_pos, window=window,
                            softcap=softcap, n_split=n_split)


def matmul(x, w):
    """Tiled matmul (K4). x: (..., K); w: (K, N) of x's type ->
    (..., N) in x's type, fp32 accumulation, at ``matmul_plan``'s path.
    No model calls it, in either package."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = cache_matmul(x2, w, plan=matmul_plan(x2.shape[0], w.shape[1],
                                               x2.shape[1]))
    return out.reshape(*lead, w.shape[1])


def matmul_q8(x, qw, scale, *, plain: bool = False):
    """Dequant-fused matmul (K3): x (M, K) float @ qw (K, N) int8 with
    (N,) per-output-channel scales applied once to the fp32 total ->
    (M, N) in x's type, at ``matmul_plan(M, N, K)``'s path. No float copy
    of the weights is written. JAX's ``matmul_q8`` returns the kernel's
    output upcast to fp32 (``repro/kernels/ops.py:100-116``); this returns
    it as it is, since the only caller, ``qeinsum``, casts to x's type
    either way: its bits are the same, without the round trip. ``plain``
    runs the plain version on any device: the reference path the card
    check holds K3 against, as ``plain_attention`` is for K1/K2. JAX's
    ``"xla"`` implementation (``set_quant_matmul_impl``) has no
    counterpart on the card: a CUDA tensor launches K3 or raises."""
    if plain:
        return int8_matmul_plain(x, qw, scale)
    return int8_matmul(x, qw, scale, plan=matmul_plan(x.shape[0],
                                                      qw.shape[1],
                                                      x.shape[1]))


def lru_scan(a, b, *, plain: bool = False):
    """RG-LRU linear scan (K5): h_t = a_t * h_{t-1} + b_t from h = 0.
    a, b: (B, S, W), cast to fp32 as the TPU wrapper casts them -> h
    (B, S, W) fp32. The kernel takes any S: the TPU wrapper's identity
    padding (a = 1, b = 0) to whole seq blocks is not needed. ``plain``
    runs the plain version on any device: the reference path the card
    check holds K5 against, as ``plain_attention`` is for K1/K2."""
    a, b = a.float(), b.float()
    if plain:
        return rglru_scan_plain(a, b)
    return rglru_scan(a, b)
