"""Shared layers: norms, rotary embeddings, embeddings, MLPs, init helpers.

Port of ``repro/models/layers.py``. Functions take the JAX package's
parameter layout (nested dicts; ``w_up`` as (d, d_ff), ``w_down`` as
(d_ff, d)) so the weight bridge needs no transpose.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.quant.weights import is_quantized, qeinsum


# ---------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, in_axis_dims, dtype):
    """Truncated-normal (within 2 sigma) fan-in init, drawn in fp32 from
    ``gen`` on its device and cast to ``dtype``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    x = u.erfinv_().mul_(math.sqrt(2)).clamp_(-2.0, 2.0)
    return x.mul_(1.0 / math.sqrt(float(in_axis_dims))).to(dtype)


# --------------------------------------------------------------------- norms
def norm_init(cfg, device, d=None):
    d = d or cfg.d_model
    p = {"scale": torch.ones(d, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, device=device)
    return p


def apply_norm(cfg, p, x, eps=1e-6):
    """LayerNorm or RMSNorm in fp32 (population variance, eps 1e-6, as in
    the JAX package), cast back to x's type."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------- rope
def rope_freqs(head_dim, base, device):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (base ** exponent)                       # (head_dim/2,)


def rope_angles(positions, head_dim, base):
    """(cos, sin), each (B, S, 1, head_dim/2) fp32, for ``positions``
    (B, S). A forward computes them once and shares them across layers."""
    freqs = rope_freqs(head_dim, base, positions.device)
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x, cos, sin):
    """Rotate-half on the split halves of x (B, S, H, D), in fp32, cast
    back to x's type."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, base):
    """x: (B, S, H, D); positions: (B, S) int."""
    return rotate(x, *rope_angles(positions, x.shape[-1], base))


# ---------------------------------------------------------------- embeddings
def embed_init(cfg, gen):
    return {"table": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                cfg.d_model, torch.float32)}


def embed_apply(cfg, p, tokens):
    """The fp32 rows are cast to the model dtype (gathering first casts
    only the rows used, to the same bits as casting the whole table)."""
    return p["table"][tokens].to(cfg.torch_dtype)


def pos_embed_init(cfg, gen, max_len):
    return {"table": dense_init(gen, (max_len, cfg.d_model), cfg.d_model,
                                torch.float32)}


def lm_head_init(cfg, gen):
    return {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                            cfg.d_model, cfg.torch_dtype)}


def head_weight(cfg, params, embed_params=None):
    """The (d_model, padded_vocab) output matrix in the model dtype
    (``params`` is the ``lm_head`` subtree). With tied embeddings it is
    the fp32 table cast (0.27 GB in bf16 for Qwen2-0.5B): a decode loop
    casts it once and passes it on."""
    if cfg.tie_embeddings:
        return embed_params["table"].to(cfg.torch_dtype).T
    return params["w"]


def lm_head_apply(cfg, params, x, embed_params=None, w=None):
    """fp32 logits (B, S, padded_vocab); ``w`` is ``head_weight``'s
    matrix, cast once by the caller, or None to take it from the params."""
    if w is None:
        w = head_weight(cfg, params, embed_params)
    logits = torch.einsum("bsd,dv->bsv", x, w)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits.float() / c)
    else:
        logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:        # mask padded vocab ids
        neg = torch.finfo(torch.float32).min
        keep = torch.arange(cfg.padded_vocab, device=x.device) \
            < cfg.vocab_size
        logits = torch.where(keep, logits, neg)
    return logits


# ----------------------------------------------------------------------- mlp
def act_fn(name):
    """jax.nn.gelu defaults to the tanh approximation; so does this."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp_init(cfg, gen, d_ff=None, d_in=None):
    d_in = d_in or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    if cfg.gated_mlp:
        return {"w_in": dense_init(gen, (d_in, 2, d_ff), d_in, dt),
                "w_down": dense_init(gen, (d_ff, d_in), d_ff, dt)}
    return {"w_up": dense_init(gen, (d_in, d_ff), d_in, dt),
            "w_down": dense_init(gen, (d_ff, d_in), d_ff, dt)}


def mlp_apply(cfg, p, x, *, plain_matmul=False):
    """Float weights take ``torch.einsum`` (gated) or ``@``; quantized
    leaves go through ``qeinsum`` (K3 on the card) with JAX's equations.
    ``plain_matmul``: see ``qeinsum``."""
    if cfg.gated_mlp:
        gu = qeinsum("bsd,dcf->bscf", x, p["w_in"],
                     plain_matmul=plain_matmul)
        h = act_fn(cfg.act)(gu[:, :, 0]) * gu[:, :, 1]
    elif is_quantized(p["w_up"]):
        h = act_fn(cfg.act)(qeinsum("bsd,df->bsf", x, p["w_up"],
                                    plain_matmul=plain_matmul))
    else:
        h = act_fn(cfg.act)(x @ p["w_up"])
    if is_quantized(p["w_down"]):
        return qeinsum("bsf,fd->bsd", h, p["w_down"],
                       plain_matmul=plain_matmul)
    return h @ p["w_down"]
