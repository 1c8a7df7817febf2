"""AdamW with JAX's semantics (``repro/training/optimizer.py``).

Moments are fp32 whatever the param dtype; the gradients are clipped by
their global norm; the update is bias-corrected, decays only leaves of two
or more dimensions (the JAX layouts: a norm scale stacked over periods
counts as a matrix there too) and is computed in fp32, then cast back to
the param's dtype. ``torch.optim.AdamW`` decays otherwise, so it is not
used. The update is functional, as in JAX: new trees are returned and the
given ones are left as they were. ZeRO-1's moment sharding
(``zero1_spec``, ``opt_state_specs``) is mesh code: ROADMAP Queue 1
item 14.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.training.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def adamw_init(params):
    """fp32 zero moments beside each param and an int32 step of 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(oc: OptConfig, step):
    """Linear warmup to ``lr``, then a cosine to 0.1 x ``lr`` at
    ``total_steps``; ``step`` an int or a tensor, the result fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf in fp32, summed leaf by
    leaf in JAX's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, state):
    """One AdamW step. Returns (new params, new state, the gradients'
    global norm before clipping)."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(oc.grad_clip / (gn + 1e-9), max=1.0)
    lr = lr_schedule(oc, step)
    b1, b2 = oc.b1, oc.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + oc.eps)
        if p.dim() >= 2:          # decay matrices only (standard practice)
            u = u + oc.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    return (_pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2),
                            "step": step}, gn)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
