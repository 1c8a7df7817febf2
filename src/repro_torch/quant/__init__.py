"""Quantized serving: int8 weights and the int8 KV cache.

Port of ``repro/quant/``:
  * ``quant.weights``: symmetric per-channel int8 weight quantization
    (``quantize_params``) and ``qeinsum``, the apply site the model
    projections call (K3 on the card for a quantized leaf).
  * ``quant.policy``: which layer classes quantize (attention projections
    and the MLP; embeddings, norms and the MoE stay float).
  * ``quant.kv``: the per-(position, head) int8 KV cache, used by
    ``models.attention``.
"""
from repro_torch.quant.kv import (dequantize_kv,  # noqa: F401
                                  quantize_kv, validate_kv_quant)
from repro_torch.quant.policy import (LAYER_CLASSES,  # noqa: F401
                                      QuantPolicy, default_policy)
from repro_torch.quant.weights import (dequantize_leaf,  # noqa: F401
                                       dequantize_params, is_quantized,
                                       params_bytes, qeinsum, quantize_leaf,
                                       quantize_params,
                                       quantized_leaf_count)
