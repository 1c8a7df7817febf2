"""Stacked model: init, caches, forward, decode and sampling.

Port of ``repro/models/transformer.py`` for stacks of three blocks:
``attn`` (global attention, bidirectional for GECToR/BERT or causal),
``attn_local`` (causal sliding-window attention over a window-sized ring
cache) and ``rglru`` (Griffin's recurrent block, ``models/rglru.py``),
with QKV bias, rotary embeddings, a gated MLP and tied embeddings (Qwen2,
RecurrentGemma). Modes ``full`` (whole sequences, optionally filling
caches) and ``decode`` (one step against the caches). Parameters and
caches keep the JAX trees: one ``blocks/blk{j}`` per pattern position,
stacked over a leading period axis. The stack runs in JAX's order: for
each pattern position j, every period of ``blk{j}`` (JAX scans each
position over its periods); for a pattern of one position that is the
plain layer order. The period loop is Python (JAX scans it), and
``decode_segment``'s scan over steps is a Python loop with no host sync
inside: active rows, budgets and eos hits stay device tensors. Caches
and recurrent states are written in place (JAX returns new arrays).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import threefry
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, embed_apply, embed_init,
                                       head_weight, lm_head_apply,
                                       lm_head_init, mlp_apply, mlp_init,
                                       norm_init, pos_embed_init,
                                       rope_angles)


BLOCK_KINDS = ("attn", "attn_local", "rglru")


def _check_supported(cfg: ModelConfig):
    bad = sorted(set(cfg.pattern) - set(BLOCK_KINDS))
    if (bad or cfg.moe is not None or cfg.post_norms or cfg.enc_layers
            or cfg.vis_tokens):
        raise NotImplementedError(
            f"{cfg.name}: only stacks of {BLOCK_KINDS} blocks without MoE, "
            f"post-norms, an encoder or a vision prefix are ported "
            f"(pattern={cfg.pattern!r}); the other blocks are ROADMAP "
            f"Queue 1 items 2 and 13")
    if cfg.fused_qkv:
        raise NotImplementedError(
            f"{cfg.name}: the fused wqkv layout is ROADMAP Queue 1 item 2")


def _block_init(cfg, kind, gen, device):
    if kind == "rglru":
        return {"rglru": rglru_mod.rglru_init(cfg, gen),
                "norm2": norm_init(cfg, device),
                "mlp": mlp_init(cfg, gen)}
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
    that compare with JAX bridge JAX's weights instead. QKV biases start
    at zero, as in JAX."""
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
    params["blocks"] = {
        f"blk{j}": _stack([_block_init(cfg, kind, gen, dev)
                           for _ in range(cfg.n_periods)])
        for j, kind in enumerate(cfg.pattern)}
    return params


def make_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                dtype=torch.bfloat16, kv_quant=None, device=None):
    """Decode caches on ``device`` (default: the card), one tree per
    pattern position stacked over periods (a leading (n_periods,) axis):
    ``{k, v, pos, len}`` for an attention block, of ``max_len`` slots or,
    for ``attn_local``, a ring of ``min(max_len, window)``;
    ``{h, conv}`` fp32 zero states for an ``rglru`` block.
    ``kv_quant="int8"`` gives the attention caches int8 K/V with their
    fp32 scale planes ``k_scale``/``v_scale``."""
    _check_supported(cfg)
    caches = {}
    for j, kind in enumerate(cfg.pattern):
        if kind == "rglru":
            one = rglru_mod.rglru_state(cfg, batch, device=device)
        else:
            one = attn_mod.make_cache(
                cfg, batch, max_len, dtype=dtype,
                window=cfg.attn.window if kind == "attn_local" else None,
                quantized=kv_quant == "int8", device=device)
        caches[f"blk{j}"] = {k: t.expand(cfg.n_periods, *t.shape).clone()
                             for k, t in one.items()}
    return caches


def _apply_block(cfg, kind, p, x, positions, cache, *, mode, causal,
                 plain_attention, plain_matmul, rope, decode_width=None):
    if kind == "rglru":
        if mode == "decode":
            delta, _ = rglru_mod.rglru_step(cfg, p["rglru"], x, cache)
        else:
            delta, _ = rglru_mod.rglru_apply(cfg, p["rglru"], x, cache,
                                             plain_scan=plain_attention)
        x = x + delta
        h = apply_norm(cfg, p["norm2"], x)
        return x + mlp_apply(cfg, p["mlp"], h, plain_matmul=plain_matmul)
    window = cfg.attn.window if kind == "attn_local" else None
    h = apply_norm(cfg, p["norm1"], x)
    if mode == "decode":
        a, _ = attn_mod.attn_decode(cfg, p["attn"], h, positions, cache,
                                    window=window,
                                    plain_attention=plain_attention,
                                    plain_matmul=plain_matmul, rope=rope,
                                    decode_width=decode_width)
    else:
        a, _ = attn_mod.attn_apply(cfg, p["attn"], h, positions,
                                   causal=causal, window=window, cache=cache,
                                   plain_attention=plain_attention,
                                   plain_matmul=plain_matmul, rope=rope)
    x = x + a
    h = apply_norm(cfg, p["norm2"], x)
    return x + mlp_apply(cfg, p["mlp"], h, plain_matmul=plain_matmul)


def forward(cfg: ModelConfig, params, *, tokens, positions=None,
            caches=None, mode: str = "full", causal: bool = True,
            return_hidden: bool = False, plain_attention: bool = False,
            plain_matmul: bool = False, head_w=None,
            decode_width: int | None = None):
    """Run the model. tokens: (B, S) int; positions: (B, S), default
    0..S-1.

    ``mode="full"`` runs whole sequences and, given ``caches``
    (``make_caches``; causal prefill from empty caches), fills them;
    ``mode="decode"`` runs one step per row at ``positions`` (B, 1)
    against ``caches``. Caches are updated in place. Returns hidden
    states (B, S, d_model) in the model dtype with ``return_hidden``, else
    fp32 logits (B, S, padded_vocab); ``head_w`` is ``head_weight``'s
    matrix when the caller cast it once. ``plain_attention`` swaps the
    sequence-mixing kernels for their plain versions, K1/K2 for
    ``naive_attention`` and K5 for the plain scan; ``plain_matmul`` swaps
    K3 for its plain version (the reference path). ``decode_width``
    (decode mode) is the batch width K2's split count is chosen for,
    default the batch's own: see ``attn_decode``. Parameters may be
    ``quantize_params``' tree: its int8 projections go through K3. With
    ``cfg.embed_scale`` the embedding is scaled by sqrt(d_model), rounded
    to the model dtype, as JAX does for the Gemma family."""
    if mode in ("chunk", "verify"):
        raise NotImplementedError(
            f"mode={mode!r}: chunked prefill is ROADMAP Queue 1 item 7, "
            f"speculative verify item 10")
    if mode not in ("full", "decode"):
        raise ValueError(f"mode must be 'full' or 'decode', got {mode!r}")
    if mode == "decode" and (caches is None or positions is None):
        raise ValueError("mode='decode' needs caches and positions")
    _check_supported(cfg)
    x = embed_apply(cfg, params["embed"], tokens)
    if cfg.embed_scale:
        # JAX multiplies by the scale as an array of the model dtype; the
        # host rounds it here, so no tensor is copied to the device
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.torch_dtype).item()
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.abs_pos and "pos_embed" in params:
        tbl = params["pos_embed"]["table"]
        x = x + tbl[positions % tbl.shape[0]].to(cfg.torch_dtype)
    rope = (None if cfg.attn.rope_base is None else
            rope_angles(positions, cfg.head_dim_, cfg.attn.rope_base))
    for j, kind in enumerate(cfg.pattern):     # JAX's order: see the top
        blk = params["blocks"][f"blk{j}"]
        cache_blk = caches[f"blk{j}"] if caches is not None else None
        for i in range(cfg.n_periods):
            cache = (None if cache_blk is None else
                     {k: t[i] for k, t in cache_blk.items()})
            x = _apply_block(cfg, kind, _index_tree(blk, i), x, positions,
                             cache, mode=mode, causal=causal,
                             plain_attention=plain_attention,
                             plain_matmul=plain_matmul, rope=rope,
                             decode_width=decode_width)
    x = apply_norm(cfg, params["final_norm"], x)
    if return_hidden:
        return x
    return lm_head_apply(cfg, params.get("lm_head"), x,
                         embed_params=params["embed"], w=head_w)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------ entry points
def prefill(cfg, params, tokens, caches, **kw):
    """Causal whole-prompt forward that fills ``caches``; returns logits
    (or hidden states with ``return_hidden=True``)."""
    return forward(cfg, params, tokens=tokens, caches=caches, mode="full",
                   **kw)


def decode_step(cfg, params, tokens, positions, caches, **kw):
    """tokens: (B, 1) next-token ids; positions: (B, 1) absolute
    positions. Returns logits (B, 1, padded_vocab)."""
    return forward(cfg, params, tokens=tokens, positions=positions,
                   caches=caches, mode="decode", **kw)


def sample_logits(logits, *, temperature=None, top_k=None, seed=None,
                  positions=None):
    """Per-row token selection from last-step logits (B, V) -> int32 (B,).

    ``temperature`` (B,) float32: rows with temperature <= 0 take the
    greedy argmax (the first maximum, as ``jnp.argmax``); others sample
    from softmax(logits / temperature), optionally restricted to the row's
    ``top_k`` (B,) highest logits (<= 0 disables the filter). The draw is
    JAX's: ``categorical(fold_in(fold_in(PRNGKey(0x5EED), seed), position),
    ...)`` through ``models.threefry``, so a (seed, position) gives the
    token the JAX package gives, whatever the batch. ``temperature=None``
    is pure argmax."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if temperature is None:
        return greedy
    V = logits.shape[-1]
    lg = logits.float()
    if top_k is not None:
        k = torch.clamp(torch.where(top_k > 0, top_k, V), 1, V)
        srt = torch.sort(lg, dim=-1).values                 # ascending
        thresh = torch.gather(srt, -1, (V - k).long()[:, None])
        lg = torch.where(lg >= thresh, lg, float("-inf"))
    scaled = lg / torch.clamp(temperature, min=1e-6)[:, None]
    base = threefry.prng_key(0x5EED, device=logits.device)
    keys = threefry.fold_in(threefry.fold_in(base, seed), positions)
    sampled = threefry.categorical(keys, scaled)
    return torch.where(temperature > 0, sampled.to(torch.int32), greedy)


def decode_segment(cfg, params, tokens, positions, caches, *, n_steps: int,
                   active=None, budget=None, eos_id=None, temperature=None,
                   top_k=None, seed=None, plain_attention=False,
                   head_w=None, decode_width=None):
    """Masked, sampled multi-step decode over a fixed-width batch.

    tokens (B, 1): the token each row just generated; positions (B, 1):
    the absolute position it occupies (its KV is written there). active
    (B,) bool: rows that decode. An inactive row still runs each step on
    its frozen (token, position): it rewrites that KV slot, which in place
    stays idempotent, but its recurrent states (``rglru`` blocks) advance,
    as in JAX; batch-at-a-time serving never resumes such a row, so no
    output changes. budget (B,) int: tokens the row may still emit. eos_id
    (B,) int: per-row stop token, -1 disables. temperature / top_k / seed:
    per-row sampling, see ``sample_logits``. A row stops emitting the step
    after it emits its eos token or exhausts its budget.

    Returns (toks (B, n_steps) int32, emitted (B, n_steps) bool, state,
    caches), ``state`` = {tok, pos, active, budget, eos_hit} for a next
    segment. The steps are a Python loop that never waits for the device;
    the head matrix is cast once per call (``head_w``); ``decode_width``,
    see ``forward``."""
    B, dev = tokens.shape[0], tokens.device
    act = (torch.ones(B, dtype=torch.bool, device=dev) if active is None
           else active.to(torch.bool))
    bud = (torch.full((B,), n_steps + 1, dtype=torch.int32, device=dev)
           if budget is None else budget.to(torch.int32))
    eos = (torch.full((B,), -1, dtype=torch.int32, device=dev)
           if eos_id is None else eos_id.to(torch.int32))
    tok, pos = tokens.to(torch.int32), positions.to(torch.int32)
    eos_hit = torch.zeros(B, dtype=torch.bool, device=dev)
    if head_w is None:
        head_w = head_weight(cfg, params.get("lm_head"), params["embed"])
    toks, emits = [], []
    for _ in range(n_steps):
        logits = forward(cfg, params, tokens=tok, positions=pos,
                         caches=caches, mode="decode",
                         plain_attention=plain_attention, head_w=head_w,
                         decode_width=decode_width)
        nxt = sample_logits(logits[:, -1], temperature=temperature,
                            top_k=top_k, seed=seed, positions=pos[:, 0] + 1)
        emit = act
        nxt = torch.where(emit, nxt, tok[:, 0])
        bud = bud - emit.to(torch.int32)
        hit = emit & (eos >= 0) & (nxt == eos)
        eos_hit = eos_hit | hit
        act = act & ~hit & (bud > 0)
        pos = pos + emit[:, None].to(torch.int32)
        tok = nxt[:, None]
        toks.append(nxt)
        emits.append(emit)
    state = {"tok": tok, "pos": pos, "active": act, "budget": bud,
             "eos_hit": eos_hit}
    if not toks:
        empty = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        return empty, empty.bool(), state, caches
    return torch.stack(toks, 1), torch.stack(emits, 1), state, caches


def decode_loop(cfg, params, tokens, positions, caches, *, n_steps: int):
    """Greedy multi-token decode: the always-active, argmax-only case of
    ``decode_segment``. Returns (generated (B, n_steps) int32, caches);
    column t is the token decoded t+1 steps after ``tokens``."""
    toks, _, _, caches = decode_segment(cfg, params, tokens, positions,
                                        caches, n_steps=n_steps)
    return toks, caches
