"""Which parameter leaves quantize: the per-layer spec behind
``quantize_params``.

Port of ``repro/quant/policy.py`` (pure Python, copied so that the port
imports nothing of ``repro``). The matmul operands shrink; everything
whose precision carries weight, or whose size is negligible, stays float:

  * ``attn_proj``: q/k/v (or fused qkv) projections. Contraction over the
    leading ``d_model`` axis; per-(head, head_dim) output channels.
  * ``attn_out``: the ``wo`` output projection. Contraction over the two
    leading (heads, head_dim) axes; per-``d_model`` output channels.
  * ``mlp``: gate/up/down projections (fused ``w_in`` included).

Embeddings and the (possibly tied) lm head, norms and biases, MoE routers
and expert stacks, and recurrent-state parameters stay in their float
dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# leaf name -> (layer class, number of leading contraction axes). Scales
# are per *output* channel, i.e. over every axis after the contraction.
_LEAF_SPECS = {
    "wq": ("attn_proj", 1),
    "wk": ("attn_proj", 1),
    "wv": ("attn_proj", 1),
    "wqkv": ("attn_proj", 1),
    "wo": ("attn_out", 2),
    "w_in": ("mlp", 1),
    "w_up": ("mlp", 1),
    "w_down": ("mlp", 1),
}

# parent keys under which the leaf names above mean what the table says;
# 'mlp' excludes the MoE subtree (parent 'experts'/'shared'), whose einsums
# contract a middle axis and whose routing is precision-sensitive.
_PARENTS = {
    "attn": ("attn_proj", "attn_out"),
    "cross_attn": ("attn_proj", "attn_out"),
    "mlp": ("mlp",),
}

LAYER_CLASSES = ("attn_proj", "attn_out", "mlp")


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-layer quantization spec: which layer classes go int8."""
    classes: frozenset = frozenset(LAYER_CLASSES)

    def n_contract(self, parent: Optional[str], name: str) -> Optional[int]:
        """Leading contraction-axis count for a quantizable leaf at
        ``parent/name``, or None when the leaf stays in float."""
        spec = _LEAF_SPECS.get(name)
        if spec is None or parent is None:
            return None
        cls, nc = spec
        if cls not in self.classes or cls not in _PARENTS.get(parent, ()):
            return None
        return nc


def default_policy() -> QuantPolicy:
    """All three matmul layer classes int8; embeddings/norms/moe stay."""
    return QuantPolicy()
