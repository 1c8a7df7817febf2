"""Grouped-query attention over a full sequence and over a ring KV cache.

Port of ``repro/models/attention.py``. Weights keep the JAX layout:
``wq``/``wk``/``wv`` as (d, h, hd), ``wo`` as (h, hd, d), biases
``bq``/``bk``/``bv`` as (h, hd); or, where ``cfg.fused_qkv`` (kv heads a
multiple of 16: gemma2-27b), one ``wqkv`` as (d, Hkv, G + 2, hd) holding
each kv head's G query heads, then its k and its v, with ``bqkv`` as
(Hkv, G + 2, hd). Full-sequence
attention goes through ``ops.mha_prefill`` (K1), and single-step decode
and a speculative verify chunk through ``ops.gqa_decode`` (K2, one query
a row or spec_k + 1): the CUDA kernels on a CUDA tensor, their plain
versions on a CPU one. ``naive_attention`` is the plain path the JAX
models run, kept as the model-level reference (``plain_attention=True``),
and the attention of a prefill chunk over the cache, which no TPU kernel
covers in either package.
The projections go through ``qeinsum``: ``torch.einsum`` for a float
weight, K3 for an int8 leaf (``plain_matmul=True``: its plain version).

Caches are dicts of tensors, ``k``/``v`` (B, L, Hkv, hd), ``pos`` (B, L)
int32 absolute positions (-1 = empty slot) and ``len`` (B,) int32, as in
JAX; an int8 cache adds the fp32 scale planes ``k_scale``/``v_scale``
(B, L, Hkv) (``quant/kv.py``). Where JAX returns new arrays, the port
writes into the cache tensors in place and returns the same dict.

Decode and verify take x with zero padding rows past the B rows of
``positions`` (``transformer.forward``'s ``decode_width``): the
projections run on every row (``_project_qkv`` keeps q, k, v's first B),
the ring and K2 on the B rows, and ``pad_rows`` pads the attention's
output back for ``wo``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rope_angles, rotate
from repro_torch.quant.kv import dequantize_kv, quantize_kv
from repro_torch.quant.weights import qeinsum

NEG_INF = -1e30


def attn_init(cfg, gen, d_model=None):
    d = d_model or cfg.d_model
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    if cfg.fused_qkv:
        gq = hq // hkv
        p = {"wqkv": dense_init(gen, (d, hkv, gq + 2, hd), d, dt),
             "wo": dense_init(gen, (hq, hd, d), hq * hd, dt)}
        if cfg.attn.qkv_bias:
            p["bqkv"] = torch.zeros((hkv, gq + 2, hd), dtype=dt,
                                    device=gen.device)
        return p
    p = {"wq": dense_init(gen, (d, hq, hd), d, dt),
         "wk": dense_init(gen, (d, hkv, hd), d, dt),
         "wv": dense_init(gen, (d, hkv, hd), d, dt),
         "wo": dense_init(gen, (hq, hd, d), hq * hd, dt)}
    if cfg.attn.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((hq, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv, hd), dtype=dt, device=dev)
    return p


def _project_qkv(cfg, p, x, positions=None, rope=None, plain_matmul=False):
    """x (B, S, d) -> q (B, S, Hq, hd), k/v (B, S, Hkv, hd), with the QKV
    bias and the rotary embedding where the config has them. ``rope`` is
    ``rope_angles(positions, ...)`` when the caller computed it once for
    every layer. A fused ``wqkv`` is one product, split into q (each kv
    head's first G), k and v, as in JAX. x may carry padding rows past
    the B rows of ``positions`` (a decode step's products at a fixed M:
    see ``transformer.forward``'s ``decode_width``): the products run on
    every row, and q, k, v keep the first B."""
    if "wqkv" in p:
        B, S = x.shape[:2]
        gq = cfg.n_heads // cfg.n_kv_heads
        qkv = qeinsum("bsd,dgch->bsgch", x, p["wqkv"],
                      plain_matmul=plain_matmul)
        if cfg.attn.qkv_bias:
            qkv = qkv + p["bqkv"]
        q = qkv[:, :, :, :gq].reshape(B, S, cfg.n_heads, cfg.head_dim_)
        k, v = qkv[:, :, :, gq], qkv[:, :, :, gq + 1]
    else:
        q, k, v = (qeinsum("bsd,dhk->bshk", x, p[name],
                           plain_matmul=plain_matmul)
                   for name in ("wq", "wk", "wv"))
        if cfg.attn.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if positions is not None and q.shape[0] > positions.shape[0]:
        q, k, v = (t[:positions.shape[0]] for t in (q, k, v))
    if cfg.attn.rope_base is not None and positions is not None:
        if rope is None:
            rope = rope_angles(positions, q.shape[-1], cfg.attn.rope_base)
        q, k = rotate(q, *rope), rotate(k, *rope)
    return q, k, v


def _mask(q_pos, kv_pos, *, causal, window):
    """(..., Sq, Skv) boolean validity mask from position vectors."""
    m = kv_pos[..., None, :] >= 0
    if causal:
        m = m & (kv_pos[..., None, :] <= q_pos[..., :, None])
    if window is not None:
        m = m & (kv_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def naive_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                    softcap=None):
    """Reference O(S^2)-memory attention, as the JAX models run it.
    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); q_pos (B, Sq), kv_pos
    (B, Skv) (negative kv positions are masked)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k).float() * (D ** -0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    msk = _mask(q_pos, kv_pos, causal=causal, window=window)
    s = torch.where(msk[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, D)


# ------------------------------------------------------------------ caches
def make_cache(cfg, batch, max_len, *, window=None, dtype=torch.bfloat16,
               long_ctx=False, quantized=False, device=None):
    """Allocate a KV cache on ``device`` (default: the card): ``max_len``
    slots, or for a local layer (``window``) ``min(max_len, window)``, a
    ring, as in JAX; with ``long_ctx`` a global layer's slots are capped
    at ``cfg.attn.long_ctx_window_cap`` (the windowed-global variant,
    where the config has a cap). Float ``dtype`` K/V, or with
    ``quantized`` int8 K/V and zeroed fp32 scale planes
    ``k_scale``/``v_scale`` (B, L, Hkv)."""
    dev = resolve_device(device)
    L = max_len
    if window is not None:
        L = min(L, window)
    elif long_ctx and cfg.attn.long_ctx_window_cap is not None:
        L = min(L, cfg.attn.long_ctx_window_cap)
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim_)
    kv_dtype = torch.int8 if quantized else dtype
    cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
             "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
             "pos": torch.full((batch, L), -1, dtype=torch.int32,
                               device=dev),
             "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if quantized:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:3], dtype=torch.float32,
                                     device=dev)
    return cache


def _cache_read_kv(cache, dtype):
    """Cache K/V as float ``dtype``, int8 entries dequantized through
    their per-(position, head) scale planes. Empty slots (pos = -1) hold
    zero payload and scale and are masked by attention either way."""
    if "k_scale" in cache:
        return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
                dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def _kv_payload(cache, k, v):
    """What a K/V write stores: K/V cast to a float cache's type, or, for
    an int8 cache, quantized K/V and the scale planes of the written
    span."""
    if "k_scale" in cache:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        return {"k": qk, "k_scale": sk, "v": qv, "v_scale": sv}
    return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


# ------------------------------------------------------------------- blocks
def attn_apply(cfg, p, x, positions, *, causal, window=None, cache=None,
               plain_attention=False, plain_matmul=False, rope=None):
    """Self-attention over the whole sequence, then the ``wo`` projection.
    Returns (out, cache).

    K1 masks by index over all S columns (``kv_len`` = the padded
    length): the positions are 0..S-1 here. In the encoder, pad tokens of
    a bucket hold valid positions and are attended to, as in JAX. With a
    ``cache`` (causal prefill from an empty cache) its k/v/pos/len are
    written in place; when S >= L the last L positions go to slots
    0..L-1, as in JAX; an int8 cache gets the quantized K/V and their
    scale planes. Attention reads the fresh, unquantized k/v, as in JAX.
    ``plain_attention`` runs ``naive_attention`` instead of K1 (the
    reference the kernel path is held against); ``plain_matmul``, see
    ``qeinsum``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, rope, plain_matmul)
    softcap = cfg.attn.logit_softcap
    if plain_attention:
        a = naive_attention(q, k, v, positions, positions, causal=causal,
                            window=window, softcap=softcap)
    else:
        a = ops.mha_prefill(q, k, v, causal=causal, window=window,
                            softcap=softcap, kv_len=S)
    if cache is not None:
        L = cache["k"].shape[1]
        lo = max(0, S - L)
        n = S - lo
        for key, val in _kv_payload(cache, k[:, lo:], v[:, lo:]).items():
            cache[key][:, :n] = val
        cache["pos"][:, :n] = positions[:, lo:]
        cache["len"].fill_(S)
    return qeinsum("bshk,hkd->bsd", a, p["wo"],
                   plain_matmul=plain_matmul), cache


def attn_decode(cfg, p, x, positions, cache, *, window=None,
                plain_attention=False, plain_matmul=False, rope=None,
                decode_width=None):
    """Single-step decode. x: (B, 1, d); positions (B, 1); cache k/v:
    (B, L, Hkv, D) ring buffer. Writes each row's k/v and position at slot
    ``pos % L`` and adds one to ``len`` (in place), then attends over the
    ring through K2, which rounds each cached K/V element of a float cache
    to q's type as it loads it. An int8 cache is written first (quantized)
    and then dequantized whole to q's type for K2, the JAX order, so a
    token's own K/V is read back through its stored scale.
    ``plain_attention`` reads the cache back in q's type and runs
    ``naive_attention``, as the JAX model does; ``plain_matmul``, see
    ``qeinsum``. K2 splits the ring by ``decode_width`` (default B): a
    caller that runs one row at several widths gives its widest, and the
    row's bits do not change with the batch around it. x may carry
    padding rows past the B rows of ``positions`` (``_project_qkv``):
    the attention runs on the B rows and its output is padded back with
    zero rows for ``wo``. Returns (out, cache)."""
    B = positions.shape[0]
    q, k, v = _project_qkv(cfg, p, x, positions, rope, plain_matmul)
    L = cache["k"].shape[1]
    slot = positions[:, 0].long() % L                       # (B,)
    bidx = torch.arange(B, device=x.device)
    for key, val in _kv_payload(cache, k[:, 0], v[:, 0]).items():
        cache[key][bidx, slot] = val
    cache["pos"][bidx, slot] = positions[:, 0].to(cache["pos"].dtype)
    cache["len"] += 1
    softcap = cfg.attn.logit_softcap
    if plain_attention or "k_scale" in cache:
        rk, rv = _cache_read_kv(cache, q.dtype)
    else:                         # K2 rounds a float cache to q's type
        rk, rv = cache["k"], cache["v"]
    if plain_attention:
        out = naive_attention(q, rk, rv, positions, cache["pos"],
                              causal=True, window=window, softcap=softcap)
    else:
        out = ops.gqa_decode(q, rk, rv, positions[:, 0], cache["pos"],
                             window=window, softcap=softcap,
                             width=decode_width)
    return qeinsum("bshk,hkd->bsd", pad_rows(out, x.shape[0]), p["wo"],
                   plain_matmul=plain_matmul), cache


def attn_prefill_chunk(cfg, p, x, positions, cache, *, window=None,
                       plain_matmul=False, rope=None):
    """One chunk of an incremental prefill (JAX's ``attn_prefill_chunk``):
    the chunk's queries attend over the cached ring plus the chunk
    itself, then the chunk's K/V are written at ``positions % L`` (in
    place) and ``len`` grows by S. When S >= L only the chunk's last L
    positions are written, each at its ring slot. Stale ring entries
    sharing a slot with the chunk lie a whole window behind every query
    and empty slots hold pos = -1, so the mask drops both. Attention
    reads the fresh chunk's K/V raw and an int8 cache gets them
    quantized only at the write, as in JAX. The attention is
    ``naive_attention`` on either device: JAX computes it with jnp
    outside any Pallas kernel. x: (B, S, d); positions: (B, S) absolute.
    Returns (out, cache)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, rope, plain_matmul)
    L = cache["k"].shape[1]
    ck, cv = _cache_read_kv(cache, q.dtype)
    kv_pos = torch.cat([cache["pos"], positions.to(cache["pos"].dtype)], 1)
    out = naive_attention(q, torch.cat([ck, k], 1), torch.cat([cv, v], 1),
                          positions, kv_pos, causal=True, window=window,
                          softcap=cfg.attn.logit_softcap)
    lo = max(0, S - L)
    slots = positions[:, lo:].long() % L
    bidx = torch.arange(B, device=x.device)[:, None]
    for key, val in _kv_payload(cache, k[:, lo:], v[:, lo:]).items():
        cache[key][bidx, slots] = val
    cache["pos"][bidx, slots] = positions[:, lo:].to(cache["pos"].dtype)
    cache["len"] += S
    return qeinsum("bshk,hkd->bsd", out, p["wo"],
                   plain_matmul=plain_matmul), cache


def pad_rows(t, rows):
    """t with zero rows appended on axis 0 up to ``rows`` (t itself when
    it has as many)."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


def per_row(fn, x):
    """``fn`` applied to each position of x (B, S, ...) alone, as a
    contiguous (B, 1, ...) tensor, the results joined on axis 1: each
    product then runs at a decode step's shapes (M = B rows), whose bits
    a row keeps whatever S is. On the card a matmul's bits follow its M
    (cuBLAS and K3 pick other kernels at other M), so a verify chunk's
    row-wise work runs this way."""
    if x.shape[1] == 1:
        return fn(x)
    return torch.cat([fn(x[:, s:s + 1].contiguous())
                      for s in range(x.shape[1])], 1)


def attn_verify_chunk(cfg, p, x, positions, cache, *, window=None,
                      plain_attention=False, plain_matmul=False,
                      partition=None):
    """Speculative-verify chunk (JAX's ``attn_verify_chunk``): score S
    candidate tokens in one call, with the bits of S ``attn_decode``
    steps. x: (B, S, d); positions: (B, S) absolute. Returns (out,
    cache).

    As in JAX the chunk's K/V (quantized, with their scale planes, in an
    int8 cache) are written at ``positions % L`` first, in place, and
    ``len`` grows by S; then every query attends over the read-back ring:
    future positions of the chunk are causally masked and slots at or
    past a row's frontier hold the pos = -1 sentinel (the scheduler's
    rollback), so each query sees a decode step's live set. The
    attention is K2 with S queries a row: a float ring goes in raw (K2
    rounds it to q's type on load), an int8 ring dequantized whole, as
    ``attn_decode`` does, at K2's split ``partition`` (the engine's
    ``ops.decode_partition`` of the plain engine's ring, which a decode
    step there takes; default the kernel's own). The projections run per
    position (``per_row``) at a decode step's M. ``plain_attention``
    reads the ring back in q's type and runs ``naive_attention``, as the
    JAX model does. Requires S < L (the engine sizes the ring with
    ``spec_k`` slots of headroom: no wrap). x may carry padding rows past
    the B rows of ``positions``, as in ``attn_decode``."""
    B, S = positions.shape
    q, k, v = (torch.cat(t, 1) for t in zip(*(
        _project_qkv(cfg, p, x[:, s:s + 1].contiguous(),
                     positions[:, s:s + 1], None, plain_matmul)
        for s in range(S))))
    L = cache["k"].shape[1]
    slots = positions.long() % L
    bidx = torch.arange(B, device=x.device)[:, None]
    for key, val in _kv_payload(cache, k, v).items():
        cache[key][bidx, slots] = val
    cache["pos"][bidx, slots] = positions.to(cache["pos"].dtype)
    cache["len"] += S
    softcap = cfg.attn.logit_softcap
    if plain_attention or "k_scale" in cache:
        rk, rv = _cache_read_kv(cache, q.dtype)
    else:                         # K2 rounds a float cache to q's type
        rk, rv = cache["k"], cache["v"]
    if plain_attention:
        out = naive_attention(q, rk, rv, positions, cache["pos"],
                              causal=True, window=window, softcap=softcap)
    else:
        out = ops.gqa_decode(q, rk, rv, positions, cache["pos"],
                             window=window, softcap=softcap,
                             partition=partition)
    return per_row(lambda o: qeinsum("bshk,hkd->bsd", o, p["wo"],
                                     plain_matmul=plain_matmul),
                   pad_rows(out, x.shape[0])), cache
