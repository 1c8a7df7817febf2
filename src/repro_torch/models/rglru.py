"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of ``repro/models/rglru.py``. Block layout (one "recurrent block" of
Griffin): norm -> [branch x: linear -> causal conv4 -> RG-LRU] *
[branch g: linear -> GeLU] -> linear out, the gate projections per-head
block-diagonal. Weights keep the JAX layout: ``w_x``/``w_gate`` (d, w),
``w_out`` (w, d) in the model dtype; ``conv_w`` (4, w), ``conv_b`` (w,),
``gate_x``/``gate_a`` ``{"w": (nh, bw, bw), "b": (nh, bw)}`` and
``a_param`` (w,) in fp32.

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is
linear in h. Where the JAX block runs it through
``jax.lax.associative_scan``, ``rglru_apply`` here calls ``ops.lru_scan``
(K5 on a CUDA tensor, its plain sequential version on a CPU one); the JAX
scan is the reference it is held against. Decode is one step
(``rglru_step``). A state is ``{"h": (B, w), "conv": (B, 3, w)}`` in fp32,
as in JAX; where JAX returns a new state, the port writes the given
state's tensors in place.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import act_fn, apply_norm, dense_init, \
    norm_init

_C = 8.0  # Griffin's fixed gate sharpness constant


def rglru_init(cfg, gen):
    d = cfg.d_model
    w = cfg.rglru_rnn_width or d
    nh = cfg.n_heads
    bw = w // nh
    dev, dt, f32 = gen.device, cfg.torch_dtype, torch.float32
    # a_param so that a ~ U(0.9, 0.999) at r = 1 (Griffin init)
    a = torch.linspace(0.9, 0.999, w, dtype=f32, device=dev)
    return {
        "norm": norm_init(cfg, dev),
        "w_x": dense_init(gen, (d, w), d, dt),
        "w_gate": dense_init(gen, (d, w), d, dt),
        "conv_w": dense_init(gen, (4, w), 4, f32),
        "conv_b": torch.zeros((w,), dtype=f32, device=dev),
        "gate_x": {"w": dense_init(gen, (nh, bw, bw), bw, f32),
                   "b": torch.zeros((nh, bw), dtype=f32, device=dev)},
        "gate_a": {"w": dense_init(gen, (nh, bw, bw), bw, f32),
                   "b": torch.zeros((nh, bw), dtype=f32, device=dev)},
        "a_param": torch.log(torch.expm1(-torch.log(a) / _C)),
        "w_out": dense_init(gen, (w, d), w, dt),
    }


def rglru_state(cfg, batch, *, device=None):
    """A zero state on ``device`` (default: the card)."""
    dev = resolve_device(device)
    w = cfg.rglru_rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, 3, w), dtype=torch.float32,
                                device=dev)}


def _gates(p, xb):
    """xb: (..., w) fp32 -> (a, gated input), the gates per-head
    block-diagonal products (plain ``torch.einsum``, as JAX computes them
    outside any kernel)."""
    nh, bw = p["gate_x"]["w"].shape[0], p["gate_x"]["w"].shape[1]
    xh = xb.reshape(*xb.shape[:-1], nh, bw)
    rt = torch.sigmoid(torch.einsum("...hk,hkv->...hv", xh, p["gate_a"]["w"])
                       + p["gate_a"]["b"]).reshape(xb.shape)
    it = torch.sigmoid(torch.einsum("...hk,hkv->...hv", xh, p["gate_x"]["w"])
                       + p["gate_x"]["b"]).reshape(xb.shape)
    # jax.nn.softplus is logaddexp(x, 0)
    log_a = -_C * torch.logaddexp(p["a_param"],
                                  torch.zeros_like(p["a_param"])) * rt
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (it * xb)


def _causal_conv4(p, x, conv_state=None):
    """Depthwise causal conv of width 4. x: (B, S, w) fp32; conv_state
    (B, 3, w), the three inputs before x, or None for zeros. Returns
    (out, new_state), the sum in JAX's term order (current input first)."""
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], 3, x.shape[2]))
    xp = torch.cat([conv_state, x], dim=1)                  # (B, S+3, w)
    n, w = xp.shape[1], p["conv_w"]
    out = xp[:, 3:n] * w[3]
    for i in range(1, 4):
        out = out + xp[:, 3 - i:n - i] * w[3 - i]
    return out + p["conv_b"], xp[:, -3:]


def _branches(cfg, p, x, conv_state):
    """The block's two input branches: the conv'd x branch in fp32 (its
    product cast to fp32, as in JAX) and the GeLU gate branch in x's
    type. Returns (xb, gb, new conv state)."""
    xn = apply_norm(cfg, p["norm"], x)
    xb = (xn @ p["w_x"]).float()
    gb = act_fn("gelu")(xn @ p["w_gate"])
    xb, new_conv = _causal_conv4(p, xb, conv_state)
    return xb, gb, new_conv


def rglru_apply(cfg, p, x, state=None, *, plain_scan=False):
    """x: (B, S, d) -> (delta (B, S, d), state). Over the whole sequence:
    the scan runs through ``ops.lru_scan`` (K5 on the card;
    ``plain_scan`` takes its plain version, the reference path). A
    carried ``state`` is folded into the first step's input, as in JAX,
    and then overwritten in place with the state after the last position
    (row padding included: a right-padded row's state has run over its
    pad tokens, as in JAX)."""
    xb, gb, new_conv = _branches(cfg, p, x,
                                 None if state is None else state["conv"])
    a, b = _gates(p, xb)                                    # (B, S, w) each
    if state is not None:
        # fold the carried h into the first step: h_0' contribution
        b = torch.cat([(b[:, 0] + a[:, 0] * state["h"])[:, None], b[:, 1:]],
                      dim=1)
    h = ops.lru_scan(a, b, plain=plain_scan)
    if state is not None:
        state["h"].copy_(h[:, -1])
        state["conv"].copy_(new_conv)
    y = h.to(x.dtype) * gb.to(x.dtype)
    return y @ p["w_out"], state


def rglru_step(cfg, p, x, state):
    """Single decode step. x: (B, 1, d); ``state`` is updated in place.
    Returns (delta (B, 1, d), state)."""
    xb, gb, new_conv = _branches(cfg, p, x, state["conv"])
    a, b = _gates(p, xb)
    h = a[:, 0] * state["h"] + b[:, 0]
    state["h"].copy_(h)
    state["conv"].copy_(new_conv)
    y = h[:, None].to(x.dtype) * gb.to(x.dtype)
    return y @ p["w_out"], state

