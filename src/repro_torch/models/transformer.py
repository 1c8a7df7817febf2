"""Stacked model: init and full-sequence forward.

Port of ``repro/models/transformer.py`` for the plain attention block
(pattern ``("attn",)``), causal or bidirectional (GECToR/BERT), with no
caches. Parameters keep the JAX tree: blocks stacked over a leading period
axis under ``blocks/blk{j}``. The period stack is a Python loop over that
axis (the JAX package scans it).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, embed_apply, embed_init,
                                       lm_head_apply, lm_head_init,
                                       mlp_apply, mlp_init, norm_init,
                                       pos_embed_init)


def _check_supported(cfg: ModelConfig):
    if (tuple(cfg.pattern) != ("attn",) or cfg.moe is not None
            or cfg.post_norms or cfg.enc_layers or cfg.vis_tokens):
        raise NotImplementedError(
            f"{cfg.name}: only the plain 'attn' block stack is ported "
            f"(pattern={cfg.pattern!r}); the other blocks are ROADMAP "
            f"Queue 1 items 2 and 13")


def _block_init(cfg, gen, device):
    return {"norm1": norm_init(cfg, device),
            "attn": attn_mod.attn_init(cfg, gen),
            "norm2": norm_init(cfg, device),
            "mlp": mlp_init(cfg, gen)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random weights in the JAX package's layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default: the
    card). The same seed gives other numbers than ``jax.random``: tests
    that compare with JAX bridge JAX's weights instead."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {"embed": embed_init(cfg, gen),
              "final_norm": norm_init(cfg, dev)}
    if cfg.abs_pos:
        params["pos_embed"] = pos_embed_init(cfg, gen,
                                             min(cfg.max_seq_len, 8192))
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(cfg, gen)
    params["blocks"] = {"blk0": _stack([_block_init(cfg, gen, dev)
                                        for _ in range(cfg.n_periods)])}
    return params


def _apply_block(cfg, p, x, positions, *, causal, plain_attention):
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn_mod.attn_apply(cfg, p["attn"], h, positions, causal=causal,
                                plain_attention=plain_attention)
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_apply(cfg, p["mlp"], h)


def forward(cfg: ModelConfig, params, *, tokens, positions=None,
            mode: str = "full", causal: bool = True,
            return_hidden: bool = False, plain_attention: bool = False):
    """Run the model over whole sequences. tokens: (B, S) int.

    Returns hidden states (B, S, d_model) in the model dtype with
    ``return_hidden``, else fp32 logits (B, S, padded_vocab).
    ``plain_attention`` swaps K1 for ``naive_attention`` (the reference
    path). Only ``mode="full"`` is ported."""
    if mode != "full":
        raise NotImplementedError(
            f"mode={mode!r}: decode is ROADMAP Queue 1 item 5, chunked "
            f"prefill item 7, speculative verify item 10")
    _check_supported(cfg)
    x = embed_apply(cfg, params["embed"], tokens)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.abs_pos and "pos_embed" in params:
        tbl = params["pos_embed"]["table"]
        x = x + tbl[positions % tbl.shape[0]].to(cfg.torch_dtype)
    blk = params["blocks"]["blk0"]
    for i in range(cfg.n_periods):
        p = _index_tree(blk, i)
        x = _apply_block(cfg, p, x, positions, causal=causal,
                         plain_attention=plain_attention)
    x = apply_norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x
    return lm_head_apply(cfg, params.get("lm_head"), x,
                         embed_params=params["embed"])


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]
