"""K1: block-wise online-softmax (flash) attention.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``. On a
CUDA tensor ``flash_attention`` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu``; on a CPU tensor it runs
``flash_attention_plain``, the same block-wise algorithm in PyTorch. There
is no fallback between the two: a CUDA tensor launches the kernel or
raises.

Both read q ``(B, Sq, Hq, D)`` and k/v ``(B, Skv, Hkv, D)`` directly (the
TPU version wants ``(B*H, S, D)`` padded to whole tiles), support causal
masking, a sliding window, a logit softcap, grouped-query heads
(``Hq % Hkv == 0``; query head h reads kv head ``h // (Hq // Hkv)``) and a
``kv_len`` that masks padded kv columns, and skip the kv tiles outside each
q tile's live range exactly, as the TPU kernel does. The visit counts (kv
tiles scored per ``(b*Hq + h, q tile)``) equal ``live_block_counts``.

The backward (``flash_attention_bwd``: dQ, dK, dV from q, k, v, the
output, its cotangent and the forward's row log-sum-exps, which
``return_lse`` asks the forward for) launches ``csrc/flash_attention_bwd.cu``
on a CUDA tensor and runs ``flash_attention_bwd_plain`` on a CPU one. The
TPU kernel has none: JAX differentiates its jnp attention instead.
``ops.mha_prefill`` joins the two in a ``torch.autograd.Function``.

What bounds the kernels on the card, and what their designs do about it,
is set out at the top of the CUDA sources.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
BLOCK_K = 32                  # kv tile of the fp32 kernel (csrc: BK_F32)
BLOCK_Q = (32, 64)            # q tiles the CUDA kernel is built for
HEAD_DIMS = (64, 128, 160, 256)
# the head dims the backward kernel is built for (stablelm-12b's 160 is
# served, not trained)
BWD_HEAD_DIMS = (64, 128, 256)
# (q tiles, kv tile) the CUDA kernel is built for, by (dtype, head dim).
# fp32 runs on the CUDA cores with 32-row kv tiles, and at head dim 256
# only bq = 32 (a 64-row tile's 512 threads spill). bf16 runs on the
# tensor cores, 16 query rows a warp, with 64-row kv tiles, 32 at head
# dim 256 (its scores then take 16 registers beside the 128 of the output
# accumulators).
TILES = {
    **{(torch.float32, d): (BLOCK_Q, BLOCK_K) for d in (64, 128, 160)},
    (torch.float32, 256): ((32,), BLOCK_K),
    **{(torch.bfloat16, d): (BLOCK_Q, 64) for d in (64, 128, 160)},
    (torch.bfloat16, 256): (BLOCK_Q, 32),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
# The bf16 backward's dK/dV kernel takes up to this many blocks a (kv
# tile, kv head), one thread block cluster (csrc: MAX_CLUSTER, the
# portable limit), each over its share of the kv head's query heads.
BWD_MAX_CLUSTER = 8


def kernel_tiles(dtype, head_dim):
    """(q tiles, kv tile) of the CUDA kernel for ``dtype`` and
    ``head_dim``; a pair it is not built for (it runs only on the CPU,
    where the plain version takes any tile) gets ``(BLOCK_Q, BLOCK_K)``."""
    return TILES.get((dtype, head_dim), (BLOCK_Q, BLOCK_K))


def _live_ranges(sq, skv, *, causal, window, bq, bk, kv_len=None):
    """Per q tile, the kv tiles [lo, hi] it visits (none where hi < lo):
    the tile-liveness rule of ``live_range`` in the CUDA sources. Tiles
    wholly past ``kv_len`` are dead; lo and hi never fall as the q tile
    rises, so the q tiles that visit one kv tile are a contiguous run."""
    n_kv = -(-(kv_len or skv) // bk)
    ranges = []
    for qi in range(-(-sq // bq)):
        lo = 0 if window is None else max(0, (qi * bq - (window - 1)) // bk)
        hi = n_kv - 1 if not causal else min(n_kv - 1,
                                             (qi * bq + bq - 1) // bk)
        ranges.append((lo, hi))
    return ranges


def _live_q_run(ranges, kt):
    """(first, last) q tile of ``ranges`` that visits kv tile ``kt``, or
    None."""
    run = [qi for qi, (lo, hi) in enumerate(ranges) if lo <= kt <= hi]
    return (run[0], run[-1]) if run else None


def live_block_counts(sq, skv, *, causal, window, bq, bk, kv_len=None):
    """Live kv tiles per q tile: the oracle for the kernel's visit counts.
    Returns a list of length ceil(sq / bq)."""
    return [max(0, hi - lo + 1) for lo, hi in _live_ranges(
        sq, skv, causal=causal, window=window, bq=bq, bk=bk, kv_len=kv_len)]


def live_q_counts(sq, skv, *, causal, window, bq, bk, kv_len=None):
    """Live q tiles per kv tile: the pairs of ``live_block_counts``
    counted from the kv side, the oracle for the backward's dK/dV visit
    counts. Returns a list of length ceil(skv / bk)."""
    counts = [0] * -(-skv // bk)
    for lo, hi in _live_ranges(sq, skv, causal=causal, window=window,
                               bq=bq, bk=bk, kv_len=kv_len):
        for kt in range(lo, hi + 1):
            counts[kt] += 1
    return counts


def _check(q, k, v, causal, window, softcap, kv_len, bq, bk):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    kv_len = Skv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"kv_len={kv_len} outside [1, {Skv}]")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if bq < 1 or bk < 1:
        raise ValueError(f"tile sizes must be >= 1, got bq={bq} bk={bk}")
    return kv_len


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          softcap=None, kv_len=None, bq=64, bk=None,
                          return_lse=False):
    """The kernel's algorithm in PyTorch, tile by tile over kv (``bk``
    rows, default the kernel's tile for q's dtype and head dim).

    Scores and the running (m, l, acc) are fp32; p is cast to v's type
    before the p @ v product, as on the TPU. Returns (out (B, Sq, Hq, D) in
    q's type, visits int32 (B*Hq, ceil(Sq/bq))), and with ``return_lse``
    the rows' log-sum-exps (B, Hq, Sq) fp32 as the kernel writes them
    (``_row_lse``)."""
    if bk is None:
        bk = kernel_tiles(q.dtype, q.shape[-1])[1]
    kv_len = _check(q, k, v, causal, window, softcap, kv_len, bq, bk)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n_q, n_kv = -(-Sq // bq), -(-kv_len // bk)
    dev = q.device

    qf = q.permute(0, 2, 1, 3).float()                      # (B, Hq, Sq, D)
    qf = torch.nn.functional.pad(qf, (0, 0, 0, n_q * bq - Sq))
    qf = qf.reshape(B, Hkv, G, n_q, bq, D)
    kf = k.permute(0, 2, 1, 3)                              # (B, Hkv, Skv, D)
    vf = v.permute(0, 2, 1, 3)
    pad_kv = n_kv * bk - Skv
    if pad_kv > 0:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, pad_kv))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, pad_kv))

    q_pos = torch.arange(n_q * bq, device=dev).reshape(n_q, bq, 1)
    qi = torch.arange(n_q, device=dev)
    ranges = _live_ranges(Sq, Skv, causal=causal, window=window, bq=bq,
                          bk=bk, kv_len=kv_len)

    m = torch.full((B, Hkv, G, n_q, bq), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, n_q, bq, D), device=dev)
    visits = torch.zeros(n_q, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    for kt in range(n_kv):
        run = _live_q_run(ranges, kt)
        if run is None:
            continue
        live = (qi >= run[0]) & (qi <= run[1])              # (n_q,)
        kb = kf[:, :, kt * bk:(kt + 1) * bk].float()        # (B, Hkv, bk, D)
        vb = vf[:, :, kt * bk:(kt + 1) * bk]
        s = torch.einsum("bhgqid,bhjd->bhgqij", qf, kb) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = kt * bk + torch.arange(bk, device=dev)
        mask = (k_pos < kv_len).expand(n_q, bq, bk)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        pv = torch.einsum("bhgqij,bhjd->bhgqid", p.to(vb.dtype).float(),
                          vb.float())
        acc_new = acc * corr[..., None] + pv
        sel = live.reshape(n_q, 1)
        m = torch.where(sel, m_new, m)
        l = torch.where(sel, l_new, l)
        acc = torch.where(sel[..., None], acc_new, acc)
        visits += live.to(torch.int32)

    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.reshape(B, Hq, n_q * bq, D)[:, :, :Sq].permute(0, 2, 1, 3)
    res = (out.to(q.dtype).contiguous(),
           visits.expand(B * Hq, n_q).contiguous())
    if return_lse:
        res += (_row_lse(m, l).reshape(B, Hq, n_q * bq)[:, :, :Sq]
                .contiguous(),)
    return res


def _row_lse(m, l):
    """m + log(l), as ``row_lse`` in the CUDA source: a row with no live
    column (m stays -1e30; its output is the mean of its visited tiles'
    values) counts m as 0, so that the backward, scoring those columns 0,
    recomputes p = 1 / l; a row that visited no tile gets +1e30 (p = 0)."""
    base = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    return torch.where(l > 0, base + torch.log(l),
                       torch.full_like(l, -NEG_INF))


def _col_bounds(sq, causal, window, kv_len, device):
    """Per query row, the kv columns [c_lo, c_hi] it may see."""
    row = torch.arange(sq, device=device)
    c_hi = (torch.clamp(row, max=kv_len - 1) if causal
            else torch.full_like(row, kv_len - 1))
    c_lo = row - window + 1 if window is not None else torch.zeros_like(row)
    return c_lo, c_hi


def bwd_cluster(Hq, Hkv, dtype):
    """Blocks per (kv tile, kv head) of the backward's dK/dV kernel: one
    thread block cluster of c blocks, each over Hq / Hkv / c of the kv
    head's query heads, that add their partials in a fixed order. c is the
    largest divisor of the group Hq / Hkv up to ``BWD_MAX_CLUSTER`` (on
    the H100 each larger c measured faster at the training shapes); 1 in
    fp32 (the CUDA-core kernel has no cluster). At Qwen2-0.5B's 14/2 heads
    that is 7, at the hybrid's 16/1 8, at the encoder's 12/12 1."""
    if dtype != torch.bfloat16:
        return 1
    G = Hq // Hkv
    return max(c for c in range(1, min(G, BWD_MAX_CLUSTER) + 1)
               if G % c == 0)


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal=True,
                              window=None, softcap=None, kv_len=None, bq=64,
                              bk=None):
    """The backward's algorithm in PyTorch, tile by tile over kv (the
    forward's ``bq`` and ``bk``), all in fp32: delta = rowsum(dout * out);
    for each kv tile, the rows of the q tiles whose live range holds it
    recompute P = exp(s - lse) and dP = dout v^T, take dS = P (dP - delta)
    (times 1 - (s/c)^2 under a softcap, zero where masked), and add
    P^T dout to dV, dS^T q to dK and dS k to dQ, with P and dS rounded to
    the inputs' type before those products, as the bf16 kernel rounds them
    (the identity in fp32). A row with no live column
    scores its masked columns 0 (see ``_row_lse``). The live tiles are
    decided on the host, so nothing waits on the device (a CUDA graph can
    capture it). Returns (dq, dk, dv in
    the inputs' type, q-side visits int32 (B*Hq, ceil(Sq/bq)), kv-side
    visits int32 (B*Hq, ceil(Skv/bk)))."""
    if bk is None:
        bk = kernel_tiles(q.dtype, q.shape[-1])[1]
    kv_len = _check(q, k, v, causal, window, softcap, kv_len, bq, bk)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n_q, n_all = -(-Sq // bq), -(-Skv // bk)
    dev = q.device
    scale = D ** -0.5

    def heads(t, H):                       # (B, S, H, D) -> (B, Hkv, G, S, D)
        return t.float().permute(0, 2, 1, 3).reshape(B, Hkv, H // Hkv,
                                                     t.shape[1], D)
    qf, gf, of = heads(q, Hq), heads(dout, Hq), heads(out, Hq)
    kf = torch.nn.functional.pad(k.float().permute(0, 2, 1, 3),
                                 (0, 0, 0, n_all * bk - Skv))
    vf = torch.nn.functional.pad(v.float().permute(0, 2, 1, 3),
                                 (0, 0, 0, n_all * bk - Skv))
    delta = (gf * of).sum(-1)                               # (B, Hkv, G, Sq)
    lse = lse.float().reshape(B, Hkv, G, Sq)

    qi = torch.arange(n_q, device=dev)
    ranges = _live_ranges(Sq, Skv, causal=causal, window=window, bq=bq,
                          bk=bk, kv_len=kv_len)
    row = torch.arange(Sq, device=dev)[:, None]
    c_lo, c_hi = _col_bounds(Sq, causal, window, kv_len, dev)
    dead = (c_lo > c_hi)[:, None]

    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    q_visits = torch.zeros(n_q, dtype=torch.int32, device=dev)
    kv_visits = torch.zeros(n_all, dtype=torch.int32, device=dev)
    for kt in range(n_all):
        run = _live_q_run(ranges, kt)
        if run is None:
            continue
        q_visits += ((qi >= run[0]) & (qi <= run[1])).to(torch.int32)
        kv_visits[kt].fill_(run[1] - run[0] + 1)
        live = (row >= run[0] * bq) & (row < (run[1] + 1) * bq)  # (Sq, 1)
        cols = slice(kt * bk, (kt + 1) * bk)
        kb, vb = kf[:, :, cols], vf[:, :, cols]
        x = torch.einsum("bhgid,bhjd->bhgij", qf, kb) * scale
        dx = torch.ones_like(x)
        if softcap is not None:
            t = torch.tanh(x / softcap)
            x, dx = softcap * t, 1 - t * t
        kp = kt * bk + torch.arange(bk, device=dev)
        ok = (kp >= c_lo[:, None]) & (kp <= c_hi[:, None])   # (Sq, bk)
        s = torch.where(ok, x, torch.where(dead, 0.0, NEG_INF))
        p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.einsum("bhgid,bhjd->bhgij", gf, vb)
        ds = torch.where(ok & live, p * (dp - delta[..., None]) * dx, 0.0)
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
        dv[:, :, cols] += torch.einsum("bhgij,bhgid->bhjd", p, gf)
        dk[:, :, cols] += torch.einsum("bhgij,bhgid->bhjd", ds, qf)
        dq += torch.einsum("bhgij,bhjd->bhgid", ds, kb)

    dq = (dq * scale).reshape(B, Hq, Sq, D).permute(0, 2, 1, 3)
    dk = (dk[:, :, :Skv] * scale).permute(0, 2, 1, 3)
    dv = dv[:, :, :Skv].permute(0, 2, 1, 3)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous(),
            q_visits.expand(B * Hq, n_q).contiguous(),
            kv_visits.expand(B * Hq, n_all).contiguous())


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        i, f, p, ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, \
            ctypes.c_longlong
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f,
                       f, *([ll] * 12), p]
        lib.flash_attention_block_k.restype = i
        lib.flash_attention_block_k.argtypes = [i, i]
        for (dtype, d), (_, bk) in TILES.items():
            if lib.flash_attention_block_k(_DTYPE_CODE[dtype], d) != bk:
                raise RuntimeError(f"csrc/flash_attention.cu: the kv tile "
                                   f"for ({dtype}, {d}) is not {bk}")
    return lib


def _check_cuda(q, k, v, bq, bk):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    D = q.shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    bqs, tile_k = TILES[(q.dtype, D)]
    if bq not in bqs or bk != tile_k:
        raise ValueError(f"tiles (bq={bq}, bk={bk}) not built at head dim "
                         f"{D} in {q.dtype}: bq in {bqs}, bk == {tile_k}")
    # 16-byte rows: float4 loads (fp32), cp.async chunks (bf16)
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit head-dim stride and "
                             f"other strides that are multiples of "
                             f"{per16}, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if q.shape[0] * q.shape[2] > _MAX_GRID_Y:
        raise ValueError(f"B*Hq = {q.shape[0] * q.shape[2]} exceeds the "
                         f"grid limit {_MAX_GRID_Y}")


def flash_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    kv_len: Optional[int] = None, bq: int = 64,
                    bk: Optional[int] = None, return_visits: bool = False,
                    return_lse: bool = False):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's
    type; with ``return_visits`` also the int32 (B*Hq, ceil(Sq/bq)) visit
    counts, with ``return_lse`` (after them) the rows' fp32 log-sum-exps
    (B, Hq, Sq) for the backward, which the kernel writes from a separate
    instance (the one without them, which serving runs, is unchanged).
    ``kv_len`` (default Skv) masks the kv columns at and beyond it (the
    causal mask does not hide them when causal=False). ``bk`` defaults to
    the kernel's kv tile for q's dtype and head dim (``kernel_tiles``).

    A CPU tensor runs ``flash_attention_plain``. A CUDA tensor launches the
    kernel and adds one to ``flash_attention.launches``."""
    if bk is None:
        bk = kernel_tiles(q.dtype, q.shape[-1])[1]
    if q.device.type == "cpu":
        out, visits, *lse = flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            kv_len=kv_len, bq=bq, bk=bk, return_lse=return_lse)
        return _result(out, visits, lse, return_visits)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    kv_len = _check(q, k, v, causal, window, softcap, kv_len, bq, bk)
    _check_cuda(q, k, v, bq, bk)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    visits = torch.empty((B * Hq, -(-Sq // bq)), dtype=torch.int32,
                         device=q.device)
    lse = ([torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)]
           if return_lse else [])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            visits.data_ptr(), lse[0].data_ptr() if lse else None,
            _DTYPE_CODE[q.dtype], D, bq, B, Hq, Hkv, Sq,
            Skv, kv_len, int(bool(causal)), window or 0,
            float(softcap or 0.0), D ** -0.5,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return _result(out, visits, lse, return_visits)


flash_attention.launches = 0


def _result(out, visits, lse, return_visits):
    res = (out,) + ((visits,) if return_visits else ()) + tuple(lse)
    return res if len(res) > 1 else out


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.restype = i
        fn.argtypes = [*([p] * 12), *([i] * 13), f, f, p]
        lib.flash_attention_bwd_block_k.restype = i
        lib.flash_attention_bwd_block_k.argtypes = [i, i]
        lib.flash_attention_bwd_max_cluster.restype = i
        lib.flash_attention_bwd_max_cluster.argtypes = []
        for (dtype, d), (_, bk) in TILES.items():
            if d not in BWD_HEAD_DIMS:
                continue
            if lib.flash_attention_bwd_block_k(_DTYPE_CODE[dtype], d) != bk:
                raise RuntimeError(f"csrc/flash_attention_bwd.cu: the kv "
                                   f"tile for ({dtype}, {d}) is not {bk}")
        if lib.flash_attention_bwd_max_cluster() != BWD_MAX_CLUSTER:
            raise RuntimeError(f"csrc/flash_attention_bwd.cu: the largest "
                               f"cluster is not {BWD_MAX_CLUSTER}")
    return lib


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal=True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        kv_len: Optional[int] = None, bq: int = 64,
                        bk: Optional[int] = None,
                        return_visits: bool = False,
                        cluster: Optional[int] = None):
    """The gradients of ``flash_attention`` at the forward's tiles: q,
    k, v, its output ``out`` and ``dout`` (out's cotangent) as the forward
    took them, ``lse`` the forward's ``return_lse`` -> (dq, dk, dv) in the
    inputs' type; with ``return_visits`` also the q-side (B*Hq,
    ceil(Sq/bq)) and kv-side (B*Hq, ceil(Skv/bk)) visit counts
    (``live_block_counts``, ``live_q_counts``). ``cluster`` is the bf16
    dK/dV kernel's blocks per (kv tile, kv head), default ``bwd_cluster``'s
    (a divisor of Hq / Hkv up to ``BWD_MAX_CLUSTER``; 1 in fp32): the
    same function, its fp32 sum over the query heads split elsewhere.

    A CPU tensor runs ``flash_attention_bwd_plain``. A CUDA tensor
    launches the kernels of ``csrc/flash_attention_bwd.cu`` (two in bf16,
    three in fp32; on contiguous copies of strided inputs) and adds one to
    ``flash_attention_bwd.launches``."""
    if bk is None:
        bk = kernel_tiles(q.dtype, q.shape[-1])[1]
    if q.device.type == "cpu":
        res = flash_attention_bwd_plain(
            q, k, v, out, dout, lse, causal=causal, window=window,
            softcap=softcap, kv_len=kv_len, bq=bq, bk=bk)
        return res if return_visits else res[:3]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    kv_len = _check(q, k, v, causal, window, softcap, kv_len, bq, bk)
    q, k, v, out, dout, lse = (t.contiguous() for t in
                               (q, k, v, out, dout, lse))
    _check_cuda(q, k, v, bq, bk)
    if q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernel's head dims are "
                         f"{BWD_HEAD_DIMS}, got {q.shape[3]}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError("out and dout must have q's dtype")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {Hq}, {Sq}) float32")
    if cluster is None:
        cluster = bwd_cluster(Hq, Hkv, q.dtype)
    G = Hq // Hkv
    if not (1 <= cluster <= BWD_MAX_CLUSTER and G % cluster == 0) or \
            (q.dtype != torch.bfloat16 and cluster != 1):
        raise ValueError(f"cluster={cluster} must divide Hq/Hkv={G}, be at "
                         f"most {BWD_MAX_CLUSTER}, and be 1 in {q.dtype}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    q_visits = torch.empty((B * Hq, -(-Sq // bq)), dtype=torch.int32,
                           device=q.device)
    kv_visits = torch.empty((B * Hq, -(-Skv // bk)), dtype=torch.int32,
                            device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk,
                                     dv, kv_visits, q_visits)),
            _DTYPE_CODE[q.dtype], D, bq, bk, B, Hq, Hkv, Sq, Skv, kv_len,
            int(bool(causal)), window or 0, cluster, float(softcap or 0.0),
            D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_bwd.launches += 1
    return (dq, dk, dv, q_visits, kv_visits) if return_visits else \
        (dq, dk, dv)


flash_attention_bwd.launches = 0
