"""Mixture-of-Experts block: a top-k router and per-row capacity dispatch.

Port of ``repro/models/moe.py``: the same function, the same parameter
layouts (``router`` (d, E) fp32, ``experts/w_in`` (E, d, 2, F) with the
gate and up halves fused, ``experts/w_down`` (E, F, d), ``shared/w_gate``
and ``w_up`` (d, n_shared x F_s), ``shared/w_down`` (n_shared x F_s, d)).
Each batch row sorts its own S x K (token, expert) copies by expert id
(stably, so within an expert earlier tokens win the slots) into an
(E, C, d) buffer of C = max(int(S K cf / E), 4) slots an expert; copies
past C are dropped. The experts run as two batched products over E, and
each token sums its K weighted expert outputs in fp32 in ascending
expert id, the order of JAX's sorted scatter-add, before the cast to x's
type; the shared experts are added after it.

On the card the block must give a row the same bits every call and
whatever batch it is in, and must not wait for the host inside a
captured program. So the combine gathers instead of scattering with
atomics (``index_add_`` adds in no fixed order on CUDA), group sizes are
sums of a comparison (no ``bincount``, ``nonzero`` or ``.item()``), and
top-k is a stable descending sort, which puts the lower expert id first
among equal probabilities as ``jax.lax.top_k`` does (the zero rows a
padded decode step carries tie exactly). The expert products' M is C
rows an expert for each row in the call, and cuBLAS picks its kernel by
M. So a prefill or chunk (``grouped``, whose batch is a join of any
size) runs the block on groups of GROUP_ROWS rows, the last one padded
with zero rows: the products' M then follows the sequence length alone,
never the join. A decode step runs the batch at once, at
``decode_width`` rows whatever the width, and a speculative verify
chunk (``moe_verify``) at a decode step's M. The router's fp32 product
runs with TF32 off, as JAX's fp32 einsum. The expert products are
plain ``torch.bmm``: JAX computes them outside any Pallas kernel.

In training the backward must give the same bits every call too. The
backward of ``torch.gather`` scatter-adds with atomics on CUDA, so both
gathers of the dispatch (into the expert buffer, and back out of it)
are ``torch.autograd.Function``s whose backwards gather as well: a
token sums its kept slots' gradients in ascending expert id, and a slot
reads its one source copy's. The router's gradient flows through the
gates and the aux terms, as in JAX.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models.attention import per_row
from repro_torch.models.layers import act_fn, dense_init


def moe_init(cfg, gen):
    """Random weights in JAX's layout, drawn from ``gen`` in JAX's key
    order (``w_in``, ``w_down``, ``router``, then the shared experts)."""
    m, d, dt = cfg.moe, cfg.d_model, cfg.torch_dtype
    e_ff = m.expert_d_ff or cfg.d_ff
    s_ff = m.shared_d_ff or e_ff
    stack = {
        "w_in": dense_init(gen, (m.num_experts, d, 2, e_ff), d, dt),
        "w_down": dense_init(gen, (m.num_experts, e_ff, d), e_ff, dt)}
    p = {"router": dense_init(gen, (d, m.num_experts), d, torch.float32),
         "experts": stack}
    if m.num_shared_experts:
        width = s_ff * m.num_shared_experts
        p["shared"] = {"w_gate": dense_init(gen, (d, width), d, dt),
                       "w_up": dense_init(gen, (d, width), d, dt),
                       "w_down": dense_init(gen, (width, d), s_ff, dt)}
    return p


# Batch rows a grouped call runs the block on: the serving engine's
# default max_batch, so that a full join is one group. qwen2-moe-a2.7b's
# captured prefill of 16 prompts of 512 tokens takes 177.0 ms at 16 rows
# a group against 476.9 ms a row at a time; of one prompt, 128.7 against
# 31.4 ms ("NVIDIA H100 80GB HBM3, 700.00 W", chip_moe_rows.py).
GROUP_ROWS = 16


def capacity(cfg, S: int) -> int:
    """Slots an expert takes from one row of S tokens (JAX's C)."""
    m = cfg.moe
    return max(int(S * m.top_k * m.capacity_factor / m.num_experts), 4)


@contextlib.contextmanager
def _no_tf32():
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def route(cfg, p, x):
    """Router logits (B, S, E) fp32, probabilities, the top-k expert ids
    (B, S, K) (lower id first among ties) and their renormalized gates."""
    K = cfg.moe.top_k
    with _no_tf32():
        logits = torch.matmul(x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    ids = torch.argsort(probs, dim=-1, descending=True,
                        stable=True)[..., :K]
    gate = torch.gather(probs, -1, ids)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, ids, gate


def dispatch(cfg, ids, C):
    """The slots of each row's (token, k) copies: (src (B, E, C) flat
    copy index that fills slot c of expert e, filled (B, E, C) bool,
    slot (B, S*K) index e*C + c of each copy, kept (B, S*K) bool)."""
    B, S, K = ids.shape
    E, NK = cfg.moe.num_experts, S * K
    flat_e = ids.reshape(B, NK)
    eids = torch.arange(E, device=ids.device)
    onehot = (flat_e[..., None] == eids).to(torch.int32)       # (B, NK, E)
    sizes = onehot.sum(1)                                      # (B, E)
    start = torch.cumsum(sizes, 1) - sizes
    order = torch.argsort(flat_e, dim=1, stable=True)          # by expert
    c = torch.arange(C, device=ids.device)
    filled = c < sizes[..., None]
    src = torch.where(filled, start[..., None] + c, 0)
    src = torch.gather(order, 1, src.reshape(B, E * C)).reshape(B, E, C)
    # a copy's rank among its expert's copies, in token order
    rank = torch.gather(torch.cumsum(onehot, 1), 2,
                        flat_e[..., None])[..., 0] - 1
    kept = rank < C
    slot = flat_e * C + torch.clamp(rank, max=C - 1)
    return src, filled, slot, kept


class _RowGather(torch.autograd.Function):
    """``_row_gather`` whose backward is a gather too: row i of t's
    gradient is the sum, in fp32 and in the order listed, of the output
    rows ``back[:, i]`` names where ``back_mask`` holds. ``torch.gather``'s
    backward scatter-adds with atomics on CUDA, so a token's K gradients
    would add in no fixed order; this gives the same bits every call."""

    @staticmethod
    def forward(ctx, t, idx, mask, back, back_mask):
        ctx.save_for_backward(back, back_mask)
        return _row_gather(t, idx, mask)

    @staticmethod
    def backward(ctx, g):
        back, back_mask = ctx.saved_tensors
        acc = _row_gather(g, back[..., 0], back_mask[..., 0]).float()
        for r in range(1, back.shape[-1]):
            acc = acc + _row_gather(g, back[..., r], back_mask[..., r])
        return acc.to(g.dtype), None, None, None, None


def _row_gather(t, idx, mask):
    """t (B, N, d) -> (B, M, d): row i is t[b, idx[b, i]] where mask[b, i],
    else zeros."""
    B, M = idx.shape
    got = torch.gather(t, 1, idx[..., None].expand(B, M, t.shape[-1]))
    return torch.where(mask[..., None], got, 0)


def _gather_rows(t, idx, mask, back):
    """``_row_gather``; where grad flows to t, through ``_RowGather`` with
    the inverse map ``back()`` gives: (rows (B, N, R), mask (B, N, R))."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _RowGather.apply(t, idx, mask, *back())
    return _row_gather(t, idx, mask)


def _copies_by_id(ids, slot, kept):
    """Each token's K copies in ascending expert id: (slot (B, S, K), kept
    (B, S, K)), the dispatch's inverse map."""
    B, S, K = ids.shape
    by_id = torch.argsort(ids, dim=-1)
    return (torch.gather(slot.reshape(B, S, K), 2, by_id),
            torch.gather(kept.reshape(B, S, K), 2, by_id))


def gather(cfg, x, ids, disp):
    """The dispatch buffer (E, B*C, d) of x (B, S, d) under ``disp`` =
    ``dispatch(cfg, ids, C)``: slot c of expert e in row b holds the
    token of copy ``src`` (zeros where not ``filled``). Its backward sums
    a token's kept slots in ascending expert id."""
    src, filled, slot, kept = disp
    B, E, C = src.shape
    tok = (src // cfg.moe.top_k).reshape(B, E * C)
    buf = _gather_rows(x, tok, filled.reshape(B, E * C),
                       lambda: _copies_by_id(ids, slot, kept))
    return buf.reshape(B, E, C, -1).transpose(0, 1).reshape(E, B * C, -1)


def experts(cfg, p, buf):
    """buf (E, M, d) -> (E, M, d): the fused gate|up product, the
    activation, the down product."""
    E, M, d = buf.shape
    w_in = p["w_in"]
    F = w_in.shape[-1]
    gu = torch.bmm(buf, w_in.reshape(E, d, 2 * F)).view(E, M, 2, F)
    h = act_fn(cfg.act)(gu[:, :, 0]) * gu[:, :, 1]
    return torch.bmm(h, p["w_down"])


def combine(y, ids, gate, disp, dtype):
    """y (E, B*C, d) back to (B, S, d) in ``dtype`` under ``disp``:
    each token's K kept outputs times their gates, summed in fp32 in
    ascending expert id (the order of JAX's sorted scatter-add). The
    backward gives each slot the gradient of its one source copy."""
    src, filled, slot, kept = disp
    B, S, K = ids.shape
    E, D = y.shape[0], y.shape[-1]
    y = y.reshape(E, B, -1, D).transpose(0, 1).reshape(B, -1, D)
    got = _gather_rows(y, slot, kept,
                       lambda: (src.reshape(B, -1, 1),
                                filled.reshape(B, -1, 1)))
    w = torch.where(kept, gate.reshape(B, S * K), 0)
    contrib = got.float() * w[..., None]
    by_id = torch.argsort(ids, dim=-1)[..., None].expand(B, S, K, D)
    contrib = torch.gather(contrib.reshape(B, S, K, D), 2, by_id)
    acc = contrib[:, :, 0]
    for k in range(1, K):
        acc = acc + contrib[:, :, k]
    return acc.to(dtype)


def shared(cfg, p, x):
    """The shared experts: one gated MLP of width n_shared x F_s."""
    h = act_fn(cfg.act)(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def _block(cfg, p, x, C, *, rowwise=False):
    """The block on x (B, S, d) at once: (out (B, S, d) in x's type,
    logits, probs, ids). ``rowwise`` runs the router and the shared
    experts on each position alone (``attention.per_row``)."""
    if rowwise:
        logits, probs, ids, gate = (torch.cat(t, 1) for t in zip(*(
            route(cfg, p, x[:, s:s + 1].contiguous())
            for s in range(x.shape[1]))))
    else:
        logits, probs, ids, gate = route(cfg, p, x)
    disp = dispatch(cfg, ids, C)
    y = experts(cfg, p["experts"], gather(cfg, x, ids, disp))
    out = combine(y, ids, gate, disp, x.dtype)
    if cfg.moe.num_shared_experts:
        sh = p["shared"]
        out = out + (per_row(lambda t: shared(cfg, sh, t), x) if rowwise
                     else shared(cfg, sh, x))
    return out, logits, probs, ids


def moe_forward(cfg, p, x, *, grouped: bool = False):
    """x: (B, S, d) -> (out (B, S, d), (logits, probs, ids)), the router's
    readings for ``moe_aux``. ``grouped`` runs the block on groups of
    GROUP_ROWS rows, zero rows padding the last (see the module's
    docstring)."""
    B, S, d = x.shape
    C, R = capacity(cfg, S), GROUP_ROWS
    if not grouped:
        out, *routed = _block(cfg, p, x, C)
        return out, routed
    parts = []
    for b in range(0, B, R):
        xg = x[b:b + R]
        n = xg.shape[0]
        if n < R:
            xg = torch.cat([xg, xg.new_zeros(R - n, S, d)])
        parts.append([t[:n] for t in _block(cfg, p, xg, C)])
    out, *routed = (t[0] if len(parts) == 1 else torch.cat(t)
                    for t in zip(*parts))
    return out, routed


def moe_verify(cfg, p, x):
    """A speculative verify chunk x (B, S, d) -> (out, (logits, probs,
    ids)): JAX's function, the chunk's S x K copies a row dispatched at
    ``capacity(cfg, S)`` and a copy past it dropped (a decode step, S =
    1, drops none), with the router and the shared experts run per
    position at a decode step's M. Where ``capacity(cfg, S)`` is a decode
    step's C (S <= 31 in the full configs, S <= 7 in the smoke ones), the
    expert products run at a decode step's M too, and a row's bits do
    not follow its slot in them: where no copy is dropped, the chunk has
    the bits of S decode steps."""
    out, *routed = _block(cfg, p, x, capacity(cfg, x.shape[1]),
                          rowwise=True)
    return out, routed


def moe_aux(cfg, logits, probs, ids):
    """JAX's aux terms of the rows given: {load_balance_loss, router_z},
    fp32 scalars."""
    E = cfg.moe.num_experts
    eids = torch.arange(E, device=ids.device)
    hit = (ids[..., None] == eids).any(2).float()              # (B, S, E)
    frac_tokens = hit.mean((0, 1))
    frac_probs = probs.mean((0, 1))
    return {"load_balance_loss": E * torch.sum(frac_tokens * frac_probs),
            "router_z": torch.mean(torch.logsumexp(logits, -1) ** 2)}


def moe_apply(cfg, p, x, *, grouped: bool = False):
    """x: (B, S, d) -> (out (B, S, d), aux), JAX's ``moe_apply``."""
    out, routed = moe_forward(cfg, p, x, grouped=grouped)
    return out, moe_aux(cfg, *routed)
