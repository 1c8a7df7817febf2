"""Weight bridge: a JAX parameter tree, as nested dicts of numpy arrays,
into the port's tensors.

The port keeps the JAX package's layouts, so the bridge copies leaves and
transposes nothing: blocks stay stacked over a leading period axis under
``blocks/blk{j}`` (repro/models/transformer.py:init_params), ``wq``/``wk``/
``wv`` stay (d, h, hd), ``wo`` (h, hd, d), ``w_up`` (d, d_ff) and
``w_down`` (d_ff, d). A GECToR tree (``encoder`` plus ``detect_head`` and
``label_head``) bridges the same way, and so does a Qwen2 tree as it is:
QKV biases ``bq``/``bk``/``bv`` as (h, hd), the gated MLP's fused gate|up
``w_in`` as (d, 2, d_ff), and no ``lm_head`` (the head is the tied fp32
embedding table). A RecurrentGemma tree bridges as it is too: one
``blk{j}`` per pattern position (``blk0`` .. ``blk18``), an ``rglru``
block's ``rglru`` subtree (``w_x``/``w_gate`` (d, w), ``w_out`` (w, d),
``conv_w`` (4, w), the per-head ``gate_x``/``gate_a`` and ``a_param``)
beside its ``norm2`` and ``mlp``. A stablelm tree bridges as it is, its
norms' ``bias`` leaves and its untied ``lm_head`` (``w`` as (d,
padded_vocab)) included, and a gemma2 tree too: ``post_norm1`` and
``post_norm2`` beside each attention block's norms, and, where the config
takes the fused layout (16 kv heads), ``wqkv`` as (d, Hkv, G + 2, hd)
in place of ``wq``/``wk``/``wv``. An MoE tree bridges as it is: each
block's ``moe`` subtree in place of ``mlp``, its ``router`` (d, E) kept
fp32, ``experts/w_in`` (E, d, 2, F), ``experts/w_down`` (E, F, d) and
the ``shared`` experts' ``w_gate``/``w_up``/``w_down``. An xLSTM tree
bridges as it is: an ``mlstm`` block's ``mlstm`` subtree (``w_in`` (d,
2 dp), ``wq``/``wk``/``wv`` (dp, nh, hd), ``w_igate``/``w_fgate`` (dp,
nh) and their biases in fp32, ``cell_norm`` over dp, ``w_out`` (dp, d))
and an ``slstm`` block's ``slstm`` subtree (``w_{izfo}`` (d, nh, hd),
``r_{izfo}`` (nh, hd, hd), ``b_{izfo}`` (nh, hd) fp32, ``cell_norm`` and
the ``ffn``'s ``w_gate``/``w_up``/``w_down``). A tree from the
JAX ``quantize_params`` bridges as it is too: each quantized leaf stays a ``{"qw": int8, "scale": fp32}`` dict,
which the port's ``qeinsum`` reads. The caller converts the JAX arrays
to numpy (``jax.tree.map(np.asarray, params)``); nothing here imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.array(a)                       # a writable copy
    if a.dtype.name == "bfloat16":        # ml_dtypes.bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_torch(tree, *, device=None):
    """Nested dicts of numpy arrays -> nested dicts of tensors on
    ``device`` (default: the card), dtypes kept."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device=dev) for k, v in tree.items()}
    return _leaf(tree, dev)

