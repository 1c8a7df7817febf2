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

What bounds the kernel on the card, and what its design does about it, is
set out at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
BLOCK_K = 32                  # kv tile of the fp32 kernel (csrc: BK_F32)
BLOCK_Q = (32, 64)            # q tiles the CUDA kernel is built for
HEAD_DIMS = (64, 128, 256)
# (q tiles, kv tile) the CUDA kernel is built for, by (dtype, head dim).
# fp32 runs on the CUDA cores with 32-row kv tiles, and at head dim 256
# only bq = 32 (a 64-row tile's 512 threads spill). bf16 runs on the
# tensor cores, 16 query rows a warp, with 64-row kv tiles, 32 at head
# dim 256 (its scores then take 16 registers beside the 128 of the output
# accumulators).
TILES = {
    **{(torch.float32, d): (BLOCK_Q, BLOCK_K) for d in (64, 128)},
    (torch.float32, 256): ((32,), BLOCK_K),
    **{(torch.bfloat16, d): (BLOCK_Q, 64) for d in (64, 128)},
    (torch.bfloat16, 256): (BLOCK_Q, 32),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def kernel_tiles(dtype, head_dim):
    """(q tiles, kv tile) of the CUDA kernel for ``dtype`` and
    ``head_dim``; a pair it is not built for (it runs only on the CPU,
    where the plain version takes any tile) gets ``(BLOCK_Q, BLOCK_K)``."""
    return TILES.get((dtype, head_dim), (BLOCK_Q, BLOCK_K))


def live_block_counts(sq, skv, *, causal, window, bq, bk, kv_len=None):
    """Live kv tiles per q tile: the oracle for the kernel's visit counts.
    Returns a list of length ceil(sq / bq)."""
    n_kv = -(-(kv_len or skv) // bk)          # fully-pad tiles are dead
    counts = []
    for qi in range(-(-sq // bq)):
        lo = 0 if window is None else max(0, (qi * bq - (window - 1)) // bk)
        hi = n_kv - 1 if not causal else min(n_kv - 1,
                                             (qi * bq + bq - 1) // bk)
        counts.append(max(0, hi - lo + 1))
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
                          softcap=None, kv_len=None, bq=64, bk=None):
    """The kernel's algorithm in PyTorch, tile by tile over kv (``bk``
    rows, default the kernel's tile for q's dtype and head dim).

    Scores and the running (m, l, acc) are fp32; p is cast to v's type
    before the p @ v product, as on the TPU. Returns (out (B, Sq, Hq, D) in
    q's type, visits int32 (B*Hq, ceil(Sq/bq)))."""
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
    lo = (torch.zeros_like(qi) if window is None else
          torch.clamp(torch.div(qi * bq - (window - 1), bk,
                                rounding_mode="floor"), min=0))
    hi = (torch.full_like(qi, n_kv - 1) if not causal else
          torch.clamp((qi * bq + bq - 1) // bk, max=n_kv - 1))

    m = torch.full((B, Hkv, G, n_q, bq), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, n_q, bq, D), device=dev)
    visits = torch.zeros(n_q, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    for kt in range(n_kv):
        live = (lo <= kt) & (kt <= hi)                      # (n_q,)
        if not bool(live.any()):
            continue
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
    return (out.to(q.dtype).contiguous(),
            visits.expand(B * Hq, n_q).contiguous())


def _lib():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        i, f, p, ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, \
            ctypes.c_longlong
        fn.restype = i
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, f,
                       *([ll] * 12), p]
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
                    bk: Optional[int] = None, return_visits: bool = False):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's
    type; with ``return_visits`` also the int32 (B*Hq, ceil(Sq/bq)) visit
    counts. ``kv_len`` (default Skv) masks the kv columns at and beyond it
    (the causal mask does not hide them when causal=False). ``bk``
    defaults to the kernel's kv tile for q's dtype and head dim
    (``kernel_tiles``).

    A CPU tensor runs ``flash_attention_plain``. A CUDA tensor launches the
    kernel and adds one to ``flash_attention.launches``."""
    if bk is None:
        bk = kernel_tiles(q.dtype, q.shape[-1])[1]
    if q.device.type == "cpu":
        out, visits = flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            kv_len=kv_len, bq=bq, bk=bk)
        return (out, visits) if return_visits else out
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
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            visits.data_ptr(), _DTYPE_CODE[q.dtype], D, bq, B, Hq, Hkv, Sq,
            Skv, kv_len, int(bool(causal)), window or 0,
            float(softcap or 0.0), D ** -0.5,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return (out, visits) if return_visits else out


flash_attention.launches = 0
