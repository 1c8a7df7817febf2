"""Public wrappers around the kernels: tile-size choice and dispatch.

``mha_prefill``, ``gqa_decode``, ``matmul_q8``, ``matmul`` and
``lru_scan`` are the ports of the functions of those names in
``repro/kernels/ops.py``. The TPU wrappers transpose q/k/v to (B*H, S, D),
repeat kv_pos per kv head and pad to whole tiles (or seq blocks) before
the kernel; the Hopper kernels read (B, S, H, D), (B, L) and (M, K)
through strides and mask the ragged edges themselves, so here the
wrappers only pick the tiles (``matmul_plan`` for K3/K4).

Training: where grad is enabled and an input requires it, ``mha_prefill``
and ``lru_scan`` run through a ``torch.autograd.Function`` each, whose
backward is K1's or K5's backward kernel (their plain versions on a CPU
tensor). Elsewhere, and under ``torch.inference_mode`` as every serving
program runs, they launch exactly what they launched before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import BLOCK_K as DECODE_BLOCK_K
from repro_torch.kernels.decode_attention import (H100_SMS, decode_attention,
                                                  decode_splits)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 kernel_tiles)
from repro_torch.kernels.int8_matmul import (cache_matmul, int8_matmul,
                                             int8_matmul_plain, matmul_plan)
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                            rglru_scan_plain)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Attention(torch.autograd.Function):
    """K1 forward (with the rows' log-sum-exps) and K1 backward."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.kw)
        return dq, dk, dv, None


class _LruScan(torch.autograd.Function):
    """K5 forward and K5 backward (the reverse scan over the saved h)."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dh)


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
    CPU, where the plain version takes any tile.) Decode and verify (K2):
    bq is 1 (each query of a verify chunk is its own block, as a decode
    step's is) and bk the kernel's kv tile of 32 slots, one warp wide, so
    a short request in a long ring, or a window, pays only for its live
    tiles; the kernel is built for that one tile. The heuristic is not
    yet tuned by measurement. (The TPU table also keys on skv and the
    window.) Attention of a prefill chunk over a cache has no kernel:
    chunked prefill runs ``naive_attention`` in both packages."""
    if kind in ("decode", "verify"):
        return 1, DECODE_BLOCK_K
    if kind != "prefill":
        raise NotImplementedError(
            f"attention kind {kind!r} has no kernel: a prefill chunk over "
            f"the cache runs naive_attention in both packages")
    bqs, bk = kernel_tiles(dtype, head_dim)
    fits = [bq for bq in bqs
            if bq == 32 or sq > bq // 2 and bh * -(-sq // bq) >= 2 * H100_SMS]
    return max(fits), bk


def mha_prefill(q, k, v, *, causal=True, window=None, softcap=None,
                kv_len=None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D), at the
    tiles ``attn_block_sizes`` picks. ``kv_len`` (default Skv) masks kv
    columns at and beyond it. Differentiable where grad is enabled (K1's
    backward at the same tiles)."""
    B, Sq, Hq, D = q.shape
    bq, bk = attn_block_sizes("prefill", Sq, bh=B * Hq, head_dim=D,
                              dtype=q.dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, kv_len=kv_len,
              bq=bq, bk=bk)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, kw)
    return flash_attention(q, k, v, **kw)


def decode_partition(width: int, n_kv_heads: int, ring_len: int):
    """(n_split, per_split): K2's partition of a decode step at ``width``
    rows in a ring of ``ring_len`` slots, the split count
    ``decode_attention.decode_splits`` picks for that width, each split
    ``ceil(tiles / count)`` tiles. The partition sets the order of the
    fold, so a row's bits depend on it: a speculative engine computes it
    once from the plain engine's ring (``spec_k`` slots shorter) and its
    verify chunks, given it, fold as a decode step there does."""
    n_split = decode_splits(width, n_kv_heads, ring_len)[0]
    n_tiles = -(-ring_len // DECODE_BLOCK_K)
    return n_split, -(-n_tiles // n_split)


def gqa_decode(q, k, v, q_pos, kv_pos, *, window=None, softcap=None,
               width=None, partition=None):
    """q: (B, S, Hq, D), S = 1 for a decode step or spec_k + 1 for a
    verify chunk; k/v cache: (B, L, Hkv, D); q_pos: (B,) at S = 1, else
    (B, S); kv_pos: (B, L) int32 -> (B, S, Hq, D), at K2's one kv tile
    (the ``bk`` of ``attn_block_sizes("decode", ...)``). The split
    partition is ``partition`` where it is given (``decode_partition``;
    a ring longer than it covers gets trailing splits of dead tiles,
    which add exact zeros), else ``decode_partition(width, Hkv, L)`` for
    a fixed ``width``, which keeps a row's bits whatever B is, else the
    kernel's own choice for B rows."""
    if partition is None and width is not None:
        partition = decode_partition(width, k.shape[2], k.shape[1])
    if partition is None:
        return decode_attention(q, k, v, q_pos, kv_pos, window=window,
                                softcap=softcap)
    n_split, per_split = partition
    return decode_attention(q, k, v, q_pos, kv_pos, window=window,
                            softcap=softcap, n_split=n_split,
                            per_split=per_split)


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
    if _needs_grad(a, b):
        return _LruScan.apply(a, b)
    return rglru_scan(a, b)
