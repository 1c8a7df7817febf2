"""K2: grouped-query attention of S >= 1 queries a row over a ring KV
cache.

Port of the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``), extended with a query axis. On a CUDA tensor
``decode_attention`` launches the hand-written Hopper kernel in
``csrc/decode_attention.cu``; on a CPU tensor it runs
``decode_attention_plain``, the same tile-by-tile algorithm in PyTorch.
There is no fallback between the two: a CUDA tensor launches the kernel
or raises. A decode step runs S = 1; a speculative verify chunk runs
S = spec_k + 1 queries a row, query (b, s) computing exactly what a
single-query call at ``q_pos[b, s]`` over the same ring computes.

For each batch row b, query s and kv head h, the G = Hq / Hkv query
heads ``h*G .. h*G+G-1`` attend over the row's L cache slots. A slot is
live when ``kv_pos >= 0``, ``kv_pos <= q_pos`` and, with a window,
``kv_pos > q_pos - window``. Scores are fp32, dead slots -1e30, the online
softmax carries (m, l, acc) in fp32, p is rounded to q's type before
``p @ v`` and the output is ``acc / max(l, 1e-30)`` in q's type. Cached K
and V may be stored in fp32 under a bf16 q: each element is rounded to
q's type as it is loaded, which is what the model's
``_cache_read_kv(cache, q.dtype)`` computes, without a cast copy of the
cache. A kv tile with no live slot is skipped before either product and
not counted; the visit counts (tiles scored per (b, s, kv head)) equal
``live_tile_counts``.

The ring is split (flash-decoding): each of ``n_split`` contiguous runs
of ``per_split`` tiles keeps its own (m, l, acc), and the splits are then
folded as ``m* = max m_s``, ``l = sum l_s e^(m_s - m*)``,
``o = sum acc_s e^(m_s - m*) / max(l, 1e-30)``. The wrapper chooses the
split count from the shapes alone (``decode_splits``); the plain version
takes it as an argument and computes the same partials and fold. One
split is the single-pass order exactly. A caller may give ``per_split``
with ``n_split``: a ring longer than ``n_split x per_split`` tiles is then
covered by trailing splits of ``per_split`` tiles, so a longer ring cut
at a shorter ring's partition folds as the shorter one does (a split of
dead tiles gives (-1e30, 0, 0), which adds exact zeros).

Both read q ``(B, S, Hq, D)``, k/v ``(B, L, Hkv, D)``, q_pos ``(B,)``
(S = 1) or ``(B, S)`` and kv_pos ``(B, L)`` through their strides (the
TPU wrapper transposes, repeats kv_pos per kv head and pads to whole
tiles) and mask the ragged last tile. What bounds the kernel on the
card, and what its design does about it, is set out at the top of the
CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
BLOCK_K = 32                  # kv tile of the CUDA kernel (csrc: BK)
H100_SMS = 132
MAX_G = 16                    # query heads per kv head (csrc: MAXG)
HEAD_DIMS = (64, 128, 160, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _live(q_pos, kv_pos, window):
    """(B, L) boolean: the slots a query at q_pos (B,) may attend to."""
    live = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        live = live & (kv_pos > q_pos[:, None] - window)
    return live


def live_tile_counts(q_pos, kv_pos, *, window=None, bk=BLOCK_K,
                     n_kv_heads=1):
    """The oracle for the visit counts: live kv tiles of each batch row
    (and, for q_pos (B, S), of each of its queries), repeated for each
    kv head -> int32 numpy (B * S * n_kv_heads,)."""
    q_pos = np.asarray(q_pos, np.int64)
    kv_pos = np.asarray(kv_pos, np.int64)
    if q_pos.ndim == 2:
        return np.stack([live_tile_counts(q_pos[:, s], kv_pos, window=window,
                                          bk=bk, n_kv_heads=n_kv_heads)
                         .reshape(-1, n_kv_heads)
                         for s in range(q_pos.shape[1])], 1).reshape(-1)
    B, L = kv_pos.shape
    live = _live(q_pos, kv_pos, window)
    n = -(-L // bk)
    live = np.pad(live, ((0, 0), (0, n * bk - L)))
    tiles = live.reshape(B, n, bk).any(-1).sum(-1)
    return np.repeat(tiles, n_kv_heads).astype(np.int32)


def decode_splits(B: int, Hkv: int, L: int, *, bk: int = BLOCK_K):
    """(n_split, per_split) for the kernel's grid of (B * Hkv, n_split)
    blocks: about two blocks per SM of an H100 (``ceil(264 / (B * Hkv))``
    splits), at most one per tile, each split a run of ``per_split``
    tiles and none empty. A function of the shapes alone: nothing is read
    from the device."""
    n_tiles = -(-L // bk)
    want = min(n_tiles, max(1, -(-2 * H100_SMS // (B * Hkv))))
    per_split = -(-n_tiles // want)
    return -(-n_tiles // per_split), per_split


def _partition(n_tiles: int, n_split: int, per_split=None):
    """(n_split, per_split) of a ring of ``n_tiles`` tiles: ``n_split``
    runs of ``ceil(n_tiles / n_split)`` tiles (trailing runs may be
    empty), or with ``per_split`` runs of that many tiles, as many as
    cover the ring and at least ``n_split``."""
    if n_split < 1:
        raise ValueError(f"n_split must be >= 1, got {n_split}")
    if per_split is None:
        return n_split, max(1, -(-n_tiles // n_split))
    if per_split < 1:
        raise ValueError(f"per_split must be >= 1, got {per_split}")
    return max(n_split, -(-n_tiles // per_split)), per_split


def _q_pos2(q_pos, B, S):
    """q_pos as (B, S): (B,) is accepted for one query a row."""
    if S == 1 and tuple(q_pos.shape) == (B,):
        return q_pos[:, None]
    return q_pos


def _check(q, k, v, q_pos, kv_pos, window, softcap, bk):
    if q.dim() != 4 or q.shape[1] < 1:
        raise ValueError(f"q must be (B, S, Hq, D), got {tuple(q.shape)}")
    B, S, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    L, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if (tuple(_q_pos2(q_pos, B, S).shape) != (B, S)
            or tuple(kv_pos.shape) != (B, L)):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / kv_pos "
                         f"{tuple(kv_pos.shape)} must be ({B}, {S}) (or "
                         f"({B},) at S = 1) / ({B}, {L})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if bk < 1:
        raise ValueError(f"tile size must be >= 1, got bk={bk}")


def decode_attention_plain(q, k, v, q_pos, kv_pos, *, window=None,
                           softcap=None, bk=BLOCK_K, n_split=1,
                           per_split=None):
    """The kernel's algorithm in PyTorch, query by query and tile by tile
    over the ring, in the runs of ``_partition(n_tiles, n_split,
    per_split)`` folded as the kernel folds them. Returns (out
    (B, S, Hq, D) in q's type, visits int32 (B * S * Hkv,)). Rows whose
    tile is dead keep their (m, l, acc) unchanged; a run with no live
    tile gives (-1e30, 0, 0); nothing here waits for the device."""
    _check(q, k, v, q_pos, kv_pos, window, softcap, bk)
    B, S, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    n_split, per_split = _partition(-(-L // bk), n_split, per_split)
    q_pos = _q_pos2(q_pos, B, S)
    outs, visits = [], []
    for s in range(S):
        out, vis = _plain_query(q[:, s], k, v, q_pos[:, s], kv_pos, window,
                                softcap, bk, n_split, per_split)
        outs.append(out)
        visits.append(vis.reshape(B, Hkv))
    return (torch.stack(outs, 1),
            torch.stack(visits, 1).reshape(B * S * Hkv))


def _plain_query(q1, k, v, q_pos, kv_pos, window, softcap, bk, n_split,
                 per_split):
    """One query a row: q1 (B, Hq, D), q_pos (B,) -> (out (B, Hq, D),
    visits (B * Hkv,))."""
    B, Hq, D = q1.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q1.device
    qf = q1.reshape(B, Hkv, G, D).float()
    live = _live(q_pos.long(), kv_pos.long(), window)         # (B, L)
    n_tiles = -(-L // bk)
    visits = torch.zeros(B, dtype=torch.int32, device=dev)
    parts = []
    for s in range(n_split):
        tiles = range(s * per_split, min(n_tiles, (s + 1) * per_split))
        m, l, acc, n = _split_pass(qf, k, v, live, tiles, q1.dtype,
                                   window, softcap, bk)
        parts.append((m, l, acc))
        visits += n
    m_star = parts[0][0]
    for m, _, _ in parts[1:]:
        m_star = torch.maximum(m_star, m)
    l = torch.zeros_like(m_star)
    acc = torch.zeros((B, Hkv, G, D), device=dev)
    for m, l_s, acc_s in parts:
        w = torch.exp(m - m_star)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return (out.reshape(B, Hq, D).to(q1.dtype),
            visits.repeat_interleave(Hkv))


def _split_pass(qf, k, v, live, tiles, q_dtype, window, softcap, bk):
    """One split's online softmax over ``tiles`` from (-1e30, 0, 0):
    returns (m, l (B, Hkv, G), acc (B, Hkv, G, D), visits (B,))."""
    B, Hkv, G, D = qf.shape
    dev = qf.device
    m = torch.full((B, Hkv, G), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, D), device=dev)
    visits = torch.zeros(B, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    for j0 in (t * bk for t in tiles):
        mask = live[:, j0:j0 + bk]                            # (B, n)
        kb = k[:, j0:j0 + bk].to(q_dtype).float()             # (B, n, Hkv, D)
        vb = v[:, j0:j0 + bk].to(q_dtype).float()
        s = torch.einsum("bhgd,bjhd->bhgj", qf, kb) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        pv = torch.einsum("bhgj,bjhd->bhgd", p.to(q_dtype).float(), vb)
        acc_new = acc * corr[..., None] + pv
        tile_live = mask.any(-1)                              # (B,)
        sel = tile_live[:, None, None]
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel[..., None], acc_new, acc)
        visits += tile_live.to(torch.int32)
    return m, l, acc, visits


def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        i, f, p, ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, \
            ctypes.c_longlong
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, *([i] * 11), f, f,
                       *([ll] * 10), p]
        for name in ("decode_attention_block_k", "decode_attention_max_g"):
            getattr(lib, name).restype = i
            getattr(lib, name).argtypes = []
        if (lib.decode_attention_block_k() != BLOCK_K
                or lib.decode_attention_max_g() != MAX_G):
            raise RuntimeError("csrc/decode_attention.cu BK/MAXG != "
                               "BLOCK_K/MAX_G")
    return lib


def _check_cuda(q, k, v, q_pos, kv_pos):
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 q and "
                        f"cache, got {q.dtype} / {k.dtype}")
    if v.dtype != k.dtype:
        raise TypeError("k and v must share one dtype")
    if kv_pos.dtype != torch.int32:
        raise TypeError(f"kv_pos must be int32, got {kv_pos.dtype}")
    if any(t.device != q.device for t in (k, v, q_pos, kv_pos)):
        raise ValueError("q, k, v, q_pos and kv_pos must be on one device")
    D, G = q.shape[3], q.shape[2] // k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if G > MAX_G:
        raise ValueError(f"{G} query heads per kv head exceed {MAX_G}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit head-dim stride, got "
                             f"{t.stride()}")
    if q.shape[1] > 1 and q.stride(0) != q.shape[1] * q.stride(1):
        raise ValueError(f"q's rows (b, s) need one stride: q.stride(0) = "
                         f"S * q.stride(1), got {q.stride()}")
    per16 = 16 // k.element_size()      # cp.async copies 16-byte chunks
    for name, t in (("k", k), ("v", v)):
        if any(s % per16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned rows: strides "
                             f"{t.stride()} in multiples of {per16} "
                             f"elements and a 16-byte aligned pointer")


def decode_attention(q, k, v, q_pos, kv_pos, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     n_split: Optional[int] = None,
                     per_split: Optional[int] = None,
                     return_visits: bool = False):
    """q: (B, S, Hq, D); k/v: (B, L, Hkv, D); q_pos: (B, S), or (B,) at
    S = 1; kv_pos: (B, L) int32 (-1 = empty) -> (B, S, Hq, D) in q's
    type; with ``return_visits`` also the int32 (B * S * Hkv,) visit
    counts.

    The kv tile is the kernel's one tile, ``BLOCK_K`` slots; the ring is
    cut into ``n_split`` runs (default ``decode_splits(B * S, Hkv, L)``),
    of ``per_split`` tiles where it is given (see ``_partition``). A CPU
    tensor runs ``decode_attention_plain`` at that partition. A CUDA
    tensor launches the kernel (a split pass and a merge) and adds one to
    ``decode_attention.launches``, and at S > 1 (a verify chunk) also to
    ``decode_attention.verify_launches``."""
    _check(q, k, v, q_pos, kv_pos, window, softcap, BLOCK_K)
    B, S, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    if n_split is None:
        if per_split is not None:
            raise ValueError("per_split needs n_split")
        n_split, per_split = decode_splits(B * S, Hkv, L)
    else:
        n_split, per_split = _partition(-(-L // BLOCK_K), n_split,
                                        per_split)
    if q.device.type == "cpu":
        out, visits = decode_attention_plain(q, k, v, q_pos, kv_pos,
                                             window=window, softcap=softcap,
                                             n_split=n_split,
                                             per_split=per_split)
        return (out, visits) if return_visits else out
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    _check_cuda(q, k, v, q_pos, kv_pos)
    G = Hq // Hkv
    dev = q.device
    qp = _q_pos2(q_pos, B, S).to(torch.int32).contiguous()
    rows = B * S * Hkv
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev)
    visits = torch.empty((rows,), dtype=torch.int32, device=dev)
    m_part = torch.empty((rows * n_split * G,), device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((rows * n_split * G * D,), device=dev)
    visit_part = torch.empty((rows * n_split,), dtype=torch.int32,
                             device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), visits.data_ptr(),
            m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
            visit_part.data_ptr(), _DTYPE_CODE[q.dtype],
            _DTYPE_CODE[k.dtype], D, B, S, Hq, Hkv, L, window or 0,
            n_split, per_split, float(softcap or 0.0), D ** -0.5,
            q.stride(0) if S == 1 else q.stride(1), q.stride(2),
            *k.stride()[:3], *v.stride()[:3], *kv_pos.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    if S > 1:
        decode_attention.verify_launches += 1
    return (out, visits) if return_visits else out


decode_attention.launches = 0
decode_attention.verify_launches = 0
