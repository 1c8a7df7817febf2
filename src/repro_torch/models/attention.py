"""Self-attention over a full sequence.

Port of the full-sequence part of ``repro/models/attention.py``. Weights
keep the JAX layout: ``wq``/``wk``/``wv`` as (d, h, hd), ``wo`` as
(h, hd, d). Attention itself goes through ``ops.mha_prefill`` (K1: the
CUDA kernel on a CUDA tensor, its plain version on a CPU one);
``naive_attention`` is the plain path the JAX models run, kept as the
model-level reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

NEG_INF = -1e30


def attn_init(cfg, gen, d_model=None):
    d = d_model or cfg.d_model
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    return {"wq": dense_init(gen, (d, hq, hd), d, dt),
            "wk": dense_init(gen, (d, hkv, hd), d, dt),
            "wv": dense_init(gen, (d, hkv, hd), d, dt),
            "wo": dense_init(gen, (hq, hd, d), hq * hd, dt)}


def _project_qkv(cfg, p, x, positions=None):
    """x (B, S, d) -> q (B, S, Hq, hd), k/v (B, S, Hkv, hd). Split layout
    only, with no bias and no rotary embedding (GECToR has neither)."""
    if ("wqkv" in p or cfg.attn.qkv_bias or cfg.attn.rope_base is not None
            or cfg.fused_qkv):
        raise NotImplementedError(
            "fused QKV, QKV bias and rotary embeddings are ROADMAP Queue 1 "
            "item 2 (dense model core)")
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
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


def attn_apply(cfg, p, x, positions, *, causal, window=None,
               plain_attention=False):
    """Self-attention over the whole sequence, then the ``wo`` projection.

    Every position is attended to: ``kv_len`` is the full (padded) length,
    as in the JAX encoder, where pad tokens of a bucket hold valid
    positions and are not masked. ``plain_attention`` runs
    ``naive_attention`` instead of K1 (the reference the kernel path is
    held against)."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    softcap = cfg.attn.logit_softcap
    if plain_attention:
        a = naive_attention(q, k, v, positions, positions, causal=causal,
                            window=window, softcap=softcap)
    else:
        a = ops.mha_prefill(q, k, v, causal=causal, window=window,
                            softcap=softcap, kv_len=x.shape[1])
    return torch.einsum("bshk,hkd->bsd", a, p["wo"])
