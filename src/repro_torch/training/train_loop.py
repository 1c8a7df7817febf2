"""Training step: next-token cross-entropy and AdamW
(``repro/training/train_loop.py``).

Gradients come from ``torch.autograd`` over the port's forward, whose
sequence-mixing sites run K1 and K5 forward and backward on the card
(``kernels/ops.py``); ``value_and_grad`` stands in for
``jax.value_and_grad(..., has_aux=True)``. An MoE model's loss adds its
stack's load-balance and router-z terms as JAX's does (0.01 and 1e-3
times them); the backward through its dispatch gives the same bits
every call (``models/moe.py``). An xLSTM model's forward without
caches runs its mLSTM blocks in the chunkwise-parallel form, each query
chunk under its own checkpoint, as JAX's does. Not ported: batches with
``enc_embeds`` (whisper) or ``prefix_embeds`` (the VLM), ROADMAP Queue 1
item 13; the sequence-sharded step and the dry run's cost mode, mesh
code of item 14. Each raises.
"""
from __future__ import annotations

import functools

import torch
import torch.utils.checkpoint

from repro_torch.models import forward
from repro_torch.models.layers import lm_head_apply
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.training.tree import flatten, tree_map, unflatten

#: JAX's ``runtime_flags.COST_MODE`` (the dry run's unrolled cost
#: analysis), mesh tooling of ROADMAP Queue 1 item 14: not ported, and
#: setting it makes ``chunked_ce`` raise.
COST_MODE = False


def _ce_from_logits(logits, labels, valid):
    """(sum of -log p(label) over valid tokens, their count). The lse form
    never writes a (B, S, V) log-softmax copy."""
    labels_c = torch.where(valid, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
    return torch.sum((lse - lab) * valid), torch.sum(valid)


def chunked_ce(cfg, params, hidden, labels, valid, *, seq_chunk=512):
    """Mean cross-entropy of the head's logits over the valid tokens,
    computed per sequence chunk of ``seq_chunk`` positions, each chunk
    under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` in a scan):
    at most one chunk's fp32 (B, seq_chunk, V) logits live at a time, and
    the backward recomputes them."""
    if COST_MODE:
        raise NotImplementedError(
            "COST_MODE (the dry run's cost analysis) is mesh tooling: "
            "ROADMAP Queue 1 item 14")
    B, S, _ = hidden.shape

    def body(h, lab, val):
        logits = lm_head_apply(cfg, params.get("lm_head"), h,
                               embed_params=params["embed"])
        return _ce_from_logits(logits, lab, val)

    if S <= seq_chunk:
        tot, cnt = body(hidden, labels, valid)
        return tot / torch.clamp(cnt, min=1)
    pad = (-S) % seq_chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    tot = cnt = 0.0
    for c in range(hidden.shape[1] // seq_chunk):
        sl = slice(c * seq_chunk, (c + 1) * seq_chunk)
        args = (hidden[:, sl], labels[:, sl], valid[:, sl])
        if torch.is_grad_enabled():
            t, n = torch.utils.checkpoint.checkpoint(body, *args,
                                                     use_reentrant=False)
        else:
            t, n = body(*args)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(torch.as_tensor(cnt), min=1)


def loss_fn(cfg, params, batch, *, remat=True, seq_shard=False,
            plain_attention=False):
    """batch: {"tokens": (B, S+1) int}. Labels are the tokens shifted by
    one; labels of -1 are masked. Returns (loss, {"nll", "load_balance",
    "router_z"}), the aux terms summed over an MoE stack (0 without
    one). ``plain_attention`` runs ``naive_attention`` and the
    plain scan instead of K1 and K5 (the reference path the card's
    gradients are held against)."""
    if seq_shard:
        raise NotImplementedError(
            "seq_shard: the sequence-sharded step is mesh code, ROADMAP "
            "Queue 1 item 14")
    for key in ("enc_embeds", "prefix_embeds"):
        if key in batch:
            raise NotImplementedError(
                f"batches with {key!r} (whisper's encoder, the VLM's "
                f"vision prefix) are ROADMAP Queue 1 item 13")
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    hidden, aux = forward(cfg, params, tokens=inputs, remat=remat,
                          return_hidden=True, return_aux=True,
                          plain_attention=plain_attention)
    valid = labels >= 0
    nll = chunked_ce(cfg, params, hidden, labels, valid)
    lb, rz = aux[0], aux[1]
    total = nll + 0.01 * lb + 1e-3 * rz
    return total, {"nll": nll, "load_balance": lb, "router_z": rz}


def value_and_grad(fn, params):
    """``jax.value_and_grad(fn, has_aux=True)(params)``: fn(params) ->
    (loss, aux). Returns ((loss, aux) detached, grads), the grads a tree
    like ``params`` in each leaf's dtype (zeros where the loss does not
    reach a leaf)."""
    flat = {k: v.detach().requires_grad_(v.is_floating_point())
            for k, v in flatten(params).items()}
    with torch.enable_grad():
        loss, aux = fn(unflatten(flat))
    keys = [k for k, v in flat.items() if v.requires_grad]
    got = torch.autograd.grad(loss, [flat[k] for k in keys],
                              allow_unused=True)
    grads = {k: torch.zeros_like(v) for k, v in flat.items()}
    grads.update({k: g for k, g in zip(keys, got) if g is not None})
    aux = tree_map(lambda t: t.detach(), aux)
    return (loss.detach(), aux), unflatten(grads)


def train_step(cfg, oc: OptConfig, params, opt_state, batch, *, remat=True,
               seq_shard=False, accum_steps: int = 1):
    """One optimizer step. ``accum_steps > 1`` splits the batch into
    microbatches run one after another, their fp32 gradients summed, as
    JAX's scan does. Returns (params, opt_state, metrics), the metrics
    ``loss_fn``'s plus ``loss`` and ``grad_norm``."""
    def loss_of(mb):
        return lambda p: loss_fn(cfg, p, mb, remat=remat,
                                 seq_shard=seq_shard)

    if accum_steps <= 1:
        (loss, metrics), grads = value_and_grad(loss_of(batch), params)
    else:
        n = next(iter(batch.values())).shape[0] // accum_steps
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss, metrics = 0.0, {"nll": 0.0, "load_balance": 0.0,
                              "router_z": 0.0}
        for i in range(accum_steps):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            (l, m), g = value_and_grad(loss_of(mb), params)
            grads = tree_map(lambda a, b: a + b.float(), grads, g)
            loss = loss + l
            metrics = tree_map(lambda a, b: a + b, metrics, m)
        inv = 1.0 / accum_steps
        grads = tree_map(lambda g: g * inv, grads)
        loss = loss * inv
        metrics = tree_map(lambda m: m * inv, metrics)
    params, opt_state, gn = adamw_update(oc, params, grads, opt_state)
    metrics = dict(metrics, loss=loss, grad_norm=gn)
    return params, opt_state, metrics


def make_train_step(cfg, oc: OptConfig, *, remat=True, seq_shard=False,
                    accum_steps: int = 1):
    """A (params, opt_state, batch) -> (params, opt_state, metrics)
    function."""
    return functools.partial(train_step, cfg, oc, remat=remat,
                             seq_shard=seq_shard, accum_steps=accum_steps)
