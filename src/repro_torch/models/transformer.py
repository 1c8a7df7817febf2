"""Stacked model: init, caches, forward, decode and sampling.

Port of ``repro/models/transformer.py`` for stacks of six blocks:
``attn`` (global attention, bidirectional for GECToR/BERT or causal),
``attn_global`` (the same, named as gemma2's pattern names it),
``attn_local`` (causal sliding-window attention over a window-sized ring
cache), ``rglru`` (Griffin's recurrent block, ``models/rglru.py``) and
the xLSTM blocks ``mlstm`` and ``slstm`` (``models/xlstm.py``), with QKV
bias, the fused ``wqkv`` layout, rotary embeddings, a gated MLP
or a Mixture-of-Experts block (``models/moe.py``: qwen2-moe, moonshot,
phi3.5-moe), gemma2's post-norms and softcaps, and tied or untied
embeddings (Qwen2, stablelm, gemma2, RecurrentGemma, xLSTM). Modes ``full``
(whole sequences, optionally filling caches), ``decode`` (one step
against the caches), ``chunk`` (a prefill chunk that continues the
caches) and ``verify``.
With ``long_ctx`` the global layers' caches and windows are capped at
``attn.long_ctx_window_cap`` (gemma2's windowed-global variant).
Parameters and caches keep the JAX trees: one ``blocks/blk{j}`` per
pattern position, stacked over a leading period axis. The stack runs in
JAX's order: for each pattern position j, every period of ``blk{j}``
(JAX scans each position over its periods); for a pattern of one
position that is the plain layer order, for gemma2 all local layers,
then all global ones. The period loop is Python (JAX scans it), and
``decode_segment``'s scan over steps is a Python loop with no host sync
inside: active rows, budgets and eos hits stay device tensors. Caches
and recurrent states are written in place (JAX returns new arrays).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import threefry
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_norm, embed_apply, embed_init,
                                       head_weight, lm_head_apply,
                                       lm_head_init, mlp_apply, mlp_init,
                                       norm_init, pos_embed_init,
                                       rope_angles)


BLOCK_KINDS = ("attn", "attn_global", "attn_local", "rglru", "mlstm",
               "slstm")
# the xLSTM blocks: (apply, initial state) by kind
_XLSTM = {"mlstm": (xlstm_mod.mlstm_apply, xlstm_mod.mlstm_state),
          "slstm": (xlstm_mod.slstm_apply, xlstm_mod.slstm_state)}


def _check_supported(cfg: ModelConfig):
    bad = sorted(set(cfg.pattern) - set(BLOCK_KINDS))
    if bad or cfg.enc_layers or cfg.vis_tokens:
        raise NotImplementedError(
            f"{cfg.name}: only stacks of {BLOCK_KINDS} blocks (with dense "
            f"or MoE feed-forwards) without an encoder or a vision prefix "
            f"are ported (pattern={cfg.pattern!r}); whisper's encoder and "
            f"the VLM's prefix are ROADMAP Queue 1 item 13")


def _window(cfg, kind, long_ctx):
    """The attention window of a ``kind`` layer: a local layer's own, a
    global layer's the long-context cap under ``long_ctx`` (JAX's
    ``_apply_block``), else None."""
    if kind == "attn_local":
        return cfg.attn.window
    if long_ctx and cfg.attn.long_ctx_window_cap:
        return cfg.attn.long_ctx_window_cap
    return None


def _block_init(cfg, kind, gen, device):
    if kind == "mlstm":
        return {"mlstm": xlstm_mod.mlstm_init(cfg, gen)}
    if kind == "slstm":
        return {"slstm": xlstm_mod.slstm_init(cfg, gen)}
    if kind == "rglru":
        return {"rglru": rglru_mod.rglru_init(cfg, gen),
                "norm2": norm_init(cfg, device),
                "mlp": mlp_init(cfg, gen)}
    p = {"norm1": norm_init(cfg, device),
         "attn": attn_mod.attn_init(cfg, gen),
         "norm2": norm_init(cfg, device)}
    if cfg.moe is not None:
        p["moe"] = moe_mod.moe_init(cfg, gen)
    else:
        p["mlp"] = mlp_init(cfg, gen)
    if cfg.post_norms:
        p["post_norm1"] = norm_init(cfg, device)
        p["post_norm2"] = norm_init(cfg, device)
    return p


def _init_stack(cfg, kind, gen, device):
    """One pattern position's blocks over ``cfg.n_periods`` periods, each
    period drawn in turn (the draw order of stacking per-period trees)
    into its slice of a preallocated (n_periods, ...) tensor per leaf, so
    that one period's tree is transient at a time."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = torch.empty((cfg.n_periods, *t.shape), dtype=t.dtype,
                          device=t.device)
        out[0] = t
        return out

    def put(dst, t, i):
        if isinstance(t, dict):
            for k, v in t.items():
                put(dst[k], v, i)
        else:
            dst[i] = t
    stack = alloc(_block_init(cfg, kind, gen, device))
    for i in range(1, cfg.n_periods):
        put(stack, _block_init(cfg, kind, gen, device), i)
    return stack


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
    params["blocks"] = {f"blk{j}": _init_stack(cfg, kind, gen, dev)
                        for j, kind in enumerate(cfg.pattern)}
    return params


def make_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                long_ctx: bool = False, dtype=torch.bfloat16, kv_quant=None,
                device=None):
    """Decode caches on ``device`` (default: the card), one tree per
    pattern position stacked over periods (a leading (n_periods,) axis):
    ``{k, v, pos, len}`` for an attention block, of ``max_len`` slots or,
    for ``attn_local``, a ring of ``min(max_len, window)``, and with
    ``long_ctx`` a global block's capped at
    ``attn.long_ctx_window_cap``; ``{h, conv}`` fp32 zero states for an
    ``rglru`` block; an xLSTM block's initial state (``mlstm``: ``{C, n,
    m}`` with m at -1e30; ``slstm``: ``{c, n, h, m}`` zeros).
    ``kv_quant="int8"`` gives the attention caches int8 K/V with their
    fp32 scale planes ``k_scale``/``v_scale``; recurrent states stay
    fp32."""
    _check_supported(cfg)
    caches = {}
    for j, kind in enumerate(cfg.pattern):
        if kind == "rglru":
            one = rglru_mod.rglru_state(cfg, batch, device=device)
        elif kind in _XLSTM:
            one = _XLSTM[kind][1](cfg, batch, device=device)
        else:
            one = attn_mod.make_cache(
                cfg, batch, max_len, dtype=dtype,
                window=cfg.attn.window if kind == "attn_local" else None,
                long_ctx=long_ctx, quantized=kv_quant == "int8",
                device=device)
        caches[f"blk{j}"] = {k: t.expand(cfg.n_periods, *t.shape).clone()
                             for k, t in one.items()}
    return caches


def _post_norm(cfg, p, name, y, mode):
    """gemma2's post-norm of a block's attention or MLP output (row-wise
    at a decode step's M in verify mode), or ``y`` as it is."""
    if not cfg.post_norms:
        return y
    if mode == "verify":
        return attn_mod.per_row(lambda t: apply_norm(cfg, p[name], t), y)
    return apply_norm(cfg, p[name], y)


def _rglru_step_padded(cfg, p, x, B, state):
    """The RG-LRU decode step on every row of x, the padding rows past
    the state's B included (on zero states), so that its products run at
    x's M whatever B is (RecurrentGemma-9B's (4096, 4096) products part
    at 1-8 rows from 16 on the card); only the B rows' states are
    written back."""
    if x.shape[0] == B:
        return rglru_mod.rglru_step(cfg, p, x, state)[0]
    padded = {k: attn_mod.pad_rows(t, x.shape[0]) for k, t in state.items()}
    delta, _ = rglru_mod.rglru_step(cfg, p, x, padded)
    for k, t in state.items():
        t.copy_(padded[k][:B])
    return delta


def _xlstm_step_padded(cfg, kind, p, x, B, state):
    """An xLSTM block's decode step on every row of x, the padding rows
    past the state's B included (each from the block's initial state),
    so that its products run at x's M whatever B is, as
    ``_rglru_step_padded``; only the B rows' states are written back."""
    apply, initial = _XLSTM[kind]
    if x.shape[0] == B:
        return apply(cfg, p, x, state)[0]
    pad = initial(cfg, x.shape[0] - B, device=x.device)
    padded = {k: torch.cat([t, pad[k]]) for k, t in state.items()}
    delta, _ = apply(cfg, p, x, padded)
    for k, t in state.items():
        t.copy_(padded[k][:B])
    return delta


def _moe(cfg, p, h, mode, cache, n, aux):
    """The MoE block on h: (out, aux terms of the first ``n`` rows or
    None). A verify chunk is routed whole (``moe.moe_verify``); a
    serving prefill's or chunk's rows run in groups of a fixed size, so
    the expert products' M is C slots a row whatever the join (see
    models/moe.py); a decode step and a forward without caches (training)
    run the batch at once."""
    if mode == "verify":
        f, routed = moe_mod.moe_verify(cfg, p, h)
    else:
        f, routed = moe_mod.moe_forward(
            cfg, p, h, grouped=mode == "chunk" or (mode == "full"
                                                   and cache is not None))
    if not aux:
        return f, None
    a = moe_mod.moe_aux(cfg, *(t[:n] for t in routed))
    return f, torch.stack([a["load_balance_loss"], a["router_z"]])


def _apply_block(cfg, kind, p, x, positions, cache, *, mode, causal,
                 plain_attention, plain_matmul, rope, decode_width=None,
                 partition=None, long_ctx=False, aux=False):
    """One block: (x, the (2,) fp32 (load-balance, router-z) terms of an
    MoE block's rows with ``aux``, else None). An xLSTM block adds its
    delta: a decode step at x's rows (``_xlstm_step_padded``); otherwise
    over the sequence from the cache's state, or from none (the mLSTM's
    parallel form) without caches."""
    if kind in _XLSTM:
        if mode == "decode":
            delta = _xlstm_step_padded(cfg, kind, p[kind], x,
                                       positions.shape[0], cache)
        else:
            delta, _ = _XLSTM[kind][0](cfg, p[kind], x, cache)
        return x + delta, None
    if kind == "rglru":
        if mode == "decode":
            delta = _rglru_step_padded(cfg, p["rglru"], x,
                                       positions.shape[0], cache)
        else:
            delta, _ = rglru_mod.rglru_apply(cfg, p["rglru"], x, cache,
                                             plain_scan=plain_attention)
        x = x + delta
        h = apply_norm(cfg, p["norm2"], x)
        return x + mlp_apply(cfg, p["mlp"], h,
                             plain_matmul=plain_matmul), None
    window = _window(cfg, kind, long_ctx)
    n = positions.shape[0]        # a padded step's rows past n left out
    if mode == "verify":          # row-wise work at a decode step's M
        h = attn_mod.per_row(lambda t: apply_norm(cfg, p["norm1"], t), x)
        a, _ = attn_mod.attn_verify_chunk(
            cfg, p["attn"], h, positions, cache, window=window,
            plain_attention=plain_attention, plain_matmul=plain_matmul,
            partition=partition)
        x = x + _post_norm(cfg, p, "post_norm1", a, mode)
        if cfg.moe is not None:
            h = attn_mod.per_row(lambda t: apply_norm(cfg, p["norm2"], t),
                                 x)
            f, terms = _moe(cfg, p["moe"], h, mode, cache, n, aux)
        else:
            f, terms = attn_mod.per_row(
                lambda t: mlp_apply(cfg, p["mlp"],
                                    apply_norm(cfg, p["norm2"], t),
                                    plain_matmul=plain_matmul), x), None
        return x + _post_norm(cfg, p, "post_norm2", f, mode), terms
    h = apply_norm(cfg, p["norm1"], x)
    if mode == "decode":
        a, _ = attn_mod.attn_decode(cfg, p["attn"], h, positions, cache,
                                    window=window,
                                    plain_attention=plain_attention,
                                    plain_matmul=plain_matmul, rope=rope,
                                    decode_width=decode_width)
    elif mode == "chunk":
        a, _ = attn_mod.attn_prefill_chunk(cfg, p["attn"], h, positions,
                                           cache, window=window,
                                           plain_matmul=plain_matmul,
                                           rope=rope)
    else:
        a, _ = attn_mod.attn_apply(cfg, p["attn"], h, positions,
                                   causal=causal, window=window, cache=cache,
                                   plain_attention=plain_attention,
                                   plain_matmul=plain_matmul, rope=rope)
    x = x + _post_norm(cfg, p, "post_norm1", a, mode)
    h = apply_norm(cfg, p["norm2"], x)
    if cfg.moe is not None:
        f, terms = _moe(cfg, p["moe"], h, mode, cache, n, aux)
    else:
        f, terms = mlp_apply(cfg, p["mlp"], h,
                             plain_matmul=plain_matmul), None
    return x + _post_norm(cfg, p, "post_norm2", f, mode), terms


def forward(cfg: ModelConfig, params, *, tokens, positions=None,
            caches=None, mode: str = "full", causal: bool = True,
            return_hidden: bool = False, plain_attention: bool = False,
            plain_matmul: bool = False, head_w=None,
            decode_width: int | None = None, partition=None,
            remat: bool = False, long_ctx: bool = False,
            return_aux: bool = False):
    """Run the model. tokens: (B, S) int; positions: (B, S), default
    0..S-1.

    ``mode="full"`` runs whole sequences and, given ``caches``
    (``make_caches``; causal prefill from empty caches), fills them;
    ``mode="decode"`` runs one step per row at ``positions`` (B, 1)
    against ``caches``; ``mode="chunk"`` runs a prefill chunk at
    ``positions`` (B, S) over ``caches`` and extends them (see
    ``prefill_chunk``); ``mode="verify"`` scores S candidate tokens at
    ``positions`` (B, S) with the bits of S decode steps (see
    ``verify_chunk``). Caches are updated in place. Returns hidden
    states (B, S, d_model) in the model dtype with ``return_hidden``, else
    fp32 logits (B, S, padded_vocab); ``head_w`` is ``head_weight``'s
    matrix when the caller cast it once. ``plain_attention`` swaps the
    sequence-mixing kernels for their plain versions, K1/K2 for
    ``naive_attention`` and K5 for the plain scan; ``plain_matmul`` swaps
    K3 for its plain version (the reference path). ``decode_width``
    (decode mode) is the batch width K2's split count is chosen for,
    default the batch's own: see ``attn_decode``; ``partition`` (verify
    mode) K2's (n_split, per_split), default the kernel's own: see
    ``ops.gqa_decode``. In decode and verify mode with a
    ``decode_width`` above B, the hidden states carry ``decode_width - B``
    zero rows past the batch on every device, so that every row-wise
    step (the projections, the MLP, the norms, the head) runs at M =
    decode_width whatever the width: on the H100 cuBLAS and cublasLt take
    other kernels at 1-8 rows than at 16 for gemma2-27b's ``w_down`` and
    RecurrentGemma-9B's (4096, 4096) products (``chip_blas_rows.py``),
    and a row's bits would follow its width. The attention's ring and K2
    (``attention.attn_decode``) see the B rows of ``positions``, an
    RG-LRU step runs every row on zero states past the B rows (an xLSTM
    step on its block's initial states) and writes back the B rows'
    states; the padding is cut from the result.
    Parameters may be ``quantize_params``' tree: its int8 projections go
    through K3. With ``cfg.embed_scale`` the embedding is scaled by
    sqrt(d_model), rounded to the model dtype, as JAX does for the Gemma
    family. ``remat`` (with grad enabled) runs each block under
    ``torch.utils.checkpoint`` (``use_reentrant=False``), as JAX's
    ``jax.checkpoint`` of its period body: the backward recomputes the
    block's activations, K1 and K5 included, instead of keeping them.
    ``long_ctx`` caps each global layer's window at
    ``attn.long_ctx_window_cap`` (the caches must be ``make_caches(...,
    long_ctx=True)``'s), as JAX's ``long_ctx``.
    A ``cfg.moe`` model runs ``models/moe.py``'s block in place of the
    MLP; ``return_aux`` then returns (out, aux), aux the (2,) fp32 sum over
    the stack of each block's (load-balance, router-z) terms, as JAX's
    third return value (zeros without MoE). In verify mode an MoE block
    routes the whole (B, S) chunk at its capacity as JAX's does, with the
    router and the shared experts per position (``moe.moe_verify``)."""
    if mode not in ("full", "decode", "chunk", "verify"):
        raise ValueError(f"mode must be 'full', 'decode', 'chunk' or "
                         f"'verify', got {mode!r}")
    if mode == "verify" and any(k not in ("attn", "attn_global")
                                for k in cfg.pattern):
        raise ValueError(f"mode='verify' needs a pure global-attention "
                         f"pattern (pattern={cfg.pattern!r})")
    if mode != "full" and (caches is None or positions is None):
        raise ValueError(f"mode={mode!r} needs caches and positions")
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
    if mode in ("decode", "verify") and decode_width is not None:
        x = attn_mod.pad_rows(x, decode_width)
    rope = (None if cfg.attn.rope_base is None or mode == "verify" else
            rope_angles(positions, cfg.head_dim_, cfg.attn.rope_base))
    aux = []
    for j, kind in enumerate(cfg.pattern):     # JAX's order: see the top
        blk = params["blocks"][f"blk{j}"]
        cache_blk = caches[f"blk{j}"] if caches is not None else None
        for i in range(cfg.n_periods):
            cache = (None if cache_blk is None else
                     {k: t[i] for k, t in cache_blk.items()})
            kw = dict(mode=mode, causal=causal,
                      plain_attention=plain_attention,
                      plain_matmul=plain_matmul, rope=rope,
                      decode_width=decode_width, partition=partition,
                      long_ctx=long_ctx, aux=return_aux)
            if remat and torch.is_grad_enabled():
                x, terms = torch.utils.checkpoint.checkpoint(
                    _apply_block, cfg, kind, _index_tree(blk, i), x,
                    positions, cache, use_reentrant=False, **kw)
            else:
                x, terms = _apply_block(cfg, kind, _index_tree(blk, i), x,
                                        positions, cache, **kw)
            if terms is not None:
                aux.append(terms)
    if mode == "verify":
        return attn_mod.per_row(lambda t: _final(cfg, params, t,
                                                 return_hidden, head_w),
                                x)[:B]
    out = _final(cfg, params, x, return_hidden, head_w)[:B]
    if not return_aux:
        return out
    total = torch.zeros(2, dtype=torch.float32, device=out.device)
    for a in aux:
        total = total + a
    return out, total


def _final(cfg, params, x, return_hidden, head_w):
    """The final norm, then hidden states or the head's fp32 logits."""
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


def prefill_chunk(cfg, params, tokens, positions, caches, **kw):
    """One chunk of an incremental prefill (JAX's ``prefill_chunk``).
    tokens: (B, C) the next C prompt tokens per row; positions: (B, C)
    their absolute positions. The chunk attends over what ``caches``
    hold plus itself and writes its K/V at those positions; an ``rglru``
    block carries its ``{h, conv}`` state into the chunk (K5 runs once
    per chunk with the carried state folded into its first step). Every
    chunk but a prompt's last must be full of real tokens; the last may
    carry a padded tail, which lands past the prompt as whole-prompt
    padding does. Returns logits (or hidden states with
    ``return_hidden=True``)."""
    return forward(cfg, params, tokens=tokens, positions=positions,
                   caches=caches, mode="chunk", **kw)


def decode_step(cfg, params, tokens, positions, caches, **kw):
    """tokens: (B, 1) next-token ids; positions: (B, 1) absolute
    positions. Returns logits (B, 1, padded_vocab)."""
    return forward(cfg, params, tokens=tokens, positions=positions,
                   caches=caches, mode="decode", **kw)


def verify_chunk(cfg, params, tokens, positions, caches, **kw):
    """Score S candidate tokens in one call with the bits of S
    ``decode_step`` calls (speculative decoding's verify core, JAX's
    ``verify_chunk``). tokens/positions: (B, S). Each query attends
    through K2 over the ring its chunk wrote first, and every row-wise
    product runs per position at a decode step's M (``mode="verify"``
    of ``forward``, whose ``partition`` it takes); an MoE block routes
    the chunk whole, as JAX's does (``moe.moe_verify``).
    Returns logits (B, S, padded_vocab)."""
    return forward(cfg, params, tokens=tokens, positions=positions,
                   caches=caches, mode="verify", **kw)


def spec_round(cfg, params, draft_cfg, draft_params, tokens, positions,
               caches, draft_caches, *, k: int, temperature=None,
               top_k=None, seed=None, head_w=None, draft_head_w=None,
               decode_width=None, partition=None, long_ctx=False):
    """One draft-and-verify round (JAX's ``spec_round``): propose ``k``
    tokens with the draft model, then score them with one target
    ``verify_chunk``.

    tokens (B, 1): the last committed token per row; positions (B, 1):
    its absolute position (its KV not yet written, the ``decode_segment``
    convention). The draft runs k + 1 decode steps; the last one only
    writes d_k's KV (its sample is discarded, so it skips the head), and
    after a full accept the draft's frontier matches the target's. The
    verify chunk covers [t_0, d_1..d_k] at positions p..p+k, and
    ``verify[:, j]`` is the token the target selects at position p+j+1
    by the same counter-based ``sample_logits`` as plain decode (the
    rows' temperature, top_k and seed repeated, positions p+j+1), so the
    committed stream (the leading agreements plus one target token) is
    plain decoding's, greedy or sampled. ``partition`` fixes K2's split
    partition in the verify chunk (``verify_chunk``), ``decode_width``
    the draft's steps' split count and the M at which the draft's steps
    and the verify chunk's positions run (``forward``). ``head_w`` /
    ``draft_head_w``: each model's ``head_weight`` cast once;
    ``long_ctx``, see ``forward``.

    Returns (drafts (B, k) int32, verify (B, k + 1) int32, caches,
    draft_caches); both caches hold KV through position p + k, and each
    row must be rolled back to its commit boundary
    (``CachePool.scatter_rollback``) before the next round reads them."""
    B = tokens.shape[0]
    tok, pos = tokens.to(torch.int32), positions.to(torch.int32)
    drafts = []
    for _ in range(k):
        logits = forward(draft_cfg, draft_params, tokens=tok, positions=pos,
                         caches=draft_caches, mode="decode",
                         head_w=draft_head_w, decode_width=decode_width,
                         long_ctx=long_ctx)
        nxt = sample_logits(logits[:, -1], temperature=temperature,
                            top_k=top_k, seed=seed, positions=pos[:, 0] + 1)
        drafts.append(nxt)
        tok, pos = nxt[:, None], pos + 1
    forward(draft_cfg, draft_params, tokens=tok, positions=pos,
            caches=draft_caches, mode="decode", return_hidden=True,
            decode_width=decode_width, long_ctx=long_ctx)
    drafts = torch.stack(drafts, 1)                           # (B, k)
    S = k + 1
    chunk = torch.cat([tokens.to(torch.int32), drafts], 1)     # (B, S)
    cpos = positions.to(torch.int32) + torch.arange(
        S, dtype=torch.int32, device=tokens.device)
    logits = forward(cfg, params, tokens=chunk, positions=cpos,
                     caches=caches, mode="verify", head_w=head_w,
                     decode_width=decode_width, partition=partition,
                     long_ctx=long_ctx)
    flat = logits.reshape(B * S, logits.shape[-1])
    if temperature is None:
        verify = sample_logits(flat)
    else:
        # row-major repeats keep each (seed, position) pair a decode
        # step's, so a sampled row draws what plain decoding draws
        verify = sample_logits(
            flat, temperature=temperature.repeat_interleave(S),
            top_k=top_k.repeat_interleave(S),
            seed=seed.repeat_interleave(S),
            positions=(cpos + 1).reshape(-1))
    return drafts, verify.reshape(B, S), caches, draft_caches


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
                   head_w=None, decode_width=None, long_ctx=False):
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
    the head matrix is cast once per call (``head_w``); ``decode_width``
    and ``long_ctx``, see ``forward``."""
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
                         decode_width=decode_width, long_ctx=long_ctx)
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


def decode_loop(cfg, params, tokens, positions, caches, *, n_steps: int,
                long_ctx=False):
    """Greedy multi-token decode: the always-active, argmax-only case of
    ``decode_segment``. Returns (generated (B, n_steps) int32, caches);
    column t is the token decoded t+1 steps after ``tokens``."""
    toks, _, _, caches = decode_segment(cfg, params, tokens, positions,
                                        caches, n_steps=n_steps,
                                        long_ctx=long_ctx)
    return toks, caches
