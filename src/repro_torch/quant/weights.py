"""Symmetric per-channel int8 weight quantization.

Port of ``repro/quant/weights.py``. A quantized leaf is a two-tensor dict
``{"qw": int8, "scale": fp32}`` in place of the float tensor in the
parameter tree: ``qw`` keeps the original shape, ``scale`` keeps only the
output-channel axes (one absmax/127 scale per output channel, symmetric,
no zero points). The contraction-axis count is ``qw.ndim - scale.ndim``,
so the tree needs no side metadata: the period-axis slicing of
``forward`` and the engine's tree maps see plain tensors.

``qeinsum`` is the apply site the models' projections call. A float
weight takes exactly ``torch.einsum``, the call the unquantized path made
before; a quantized leaf takes the dequant-fused matmul
(``kernels.ops.matmul_q8``: K3 on the card), with the scales applied at
the fp32 accumulator and no float copy of the weight written.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.quant.policy import QuantPolicy, default_policy

# period-stacked subtrees: leaves below carry a leading (n_periods,) batch
# axis that quantization must treat as per-layer, not as a channel
_STACKED_ROOTS = ("blocks", "enc_blocks")


def is_quantized(leaf) -> bool:
    """True for the {'qw', 'scale'} dicts ``quantize_params`` emits."""
    return isinstance(leaf, dict) and "qw" in leaf and "scale" in leaf


def _expand(scale, caxes):
    for ax in caxes:
        scale = scale.unsqueeze(ax)
    return scale


def quantize_leaf(w, n_contract: int, n_batch: int = 0) -> dict:
    """w: (*batch, *contract, *out) -> {'qw': int8 same shape,
    'scale': fp32 (*batch, *out)}. scale = absmax/127 over the contraction
    axes, per output channel; all-zero channels get scale 0 and quantize
    (and dequantize) to exact zeros. Rounds half to even, as JAX."""
    wf = w.float()
    caxes = tuple(range(n_batch, n_batch + n_contract))
    scale = wf.abs().amax(dim=caxes) / 127.0
    sb = _expand(scale, caxes)
    q = torch.round(wf / torch.where(sb > 0, sb, torch.ones_like(sb)))
    return {"qw": q.clamp_(-127, 127).to(torch.int8), "scale": scale}


def dequantize_leaf(leaf, dtype=torch.float32, n_batch: int = 0):
    """The float weight back (round-trip error <= scale/2 per element).
    ``n_batch`` must be the value quantization used (1 for period-stacked
    leaves)."""
    qw, scale = leaf["qw"], leaf["scale"]
    nc = qw.dim() - scale.dim()
    sb = _expand(scale, tuple(range(n_batch, n_batch + nc)))
    return (qw.float() * sb).to(dtype)


def quantize_params(params: dict, spec: Optional[QuantPolicy] = None) -> dict:
    """Quantize a model tree per the policy ``spec`` (default: the three
    matmul layer classes, see ``quant.policy``), on the device the leaves
    lie on. Leaves the policy leaves alone are passed through by
    reference."""
    spec = spec or default_policy()

    def walk(tree, parent, stacked):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val, key, stacked or key in _STACKED_ROOTS)
                continue
            nc = spec.n_contract(parent, key)
            out[key] = val if nc is None else quantize_leaf(
                val, nc, n_batch=1 if stacked else 0)
        return out

    return walk(params, None, False)


def dequantize_params(params: dict, dtype=torch.float32) -> dict:
    """Invert ``quantize_params`` (up to the per-element scale/2 rounding
    error)."""
    def walk(tree, stacked):
        out = {}
        for key, val in tree.items():
            if is_quantized(val):
                out[key] = dequantize_leaf(val, dtype,
                                           n_batch=1 if stacked else 0)
            elif isinstance(val, dict):
                out[key] = walk(val, stacked or key in _STACKED_ROOTS)
            else:
                out[key] = val
        return out
    return walk(params, False)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def params_bytes(params) -> int:
    """Device bytes of a (possibly quantized) tree: the ``weight_bytes``
    gauge the engine reports."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(params)))


def quantized_leaf_count(params) -> int:
    n = 0
    for val in params.values():
        if is_quantized(val):
            n += 1
        elif isinstance(val, dict):
            n += quantized_leaf_count(val)
    return n


def qeinsum(eq: str, x, w, *, plain_matmul: bool = False):
    """Projection einsum with a possibly quantized weight operand.

    Float ``w``: exactly ``torch.einsum(eq, x, w)``. Quantized ``w``: the
    einsums the models use (contraction over the trailing axes of ``x`` =
    the leading axes of ``w``; outputs = x's batch dims then w's output
    dims) collapse to one (M, K) x (K, N) ``ops.matmul_q8`` with the (N,)
    output-channel scales, whose output is already in x's type (JAX's is
    fp32, cast here; the bits are the same). ``plain_matmul`` takes
    the matmul's plain version on any device: the model-level reference,
    set only by the card check and the tests."""
    if not is_quantized(w):
        return torch.einsum(eq, x, w)
    qw, scale = w["qw"], w["scale"]
    nc = qw.dim() - scale.dim()
    lead = tuple(x.shape[:x.dim() - nc])
    K = math.prod(x.shape[x.dim() - nc:])
    out_shape = tuple(qw.shape[nc:])
    N = math.prod(out_shape)
    out = ops.matmul_q8(x.reshape(-1, K), qw.reshape(K, N),
                        scale.reshape(N), plain=plain_matmul)
    return out.reshape(lead + out_shape)
