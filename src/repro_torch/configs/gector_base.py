"""GECToR (Omelianchuk et al., 2020) — the paper's model.

BERT-base bidirectional encoder (12L d_model=768 12H d_ff=3072, learned
absolute positions, LayerNorm, GELU, non-gated MLP) with two linear heads
(error-detection + edit-tag labels) stacked on top — see core/gector.py.

SMOKE is the variant the CPU tests serve.
"""
from repro_torch.models.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gector-base", arch_type="encoder",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=30_522,
    norm="layernorm", act="gelu", gated_mlp=False, abs_pos=True,
    attn=AttnConfig(rope_base=None),
    max_seq_len=512,
)

SMOKE = ModelConfig(
    name="gector-small", arch_type="encoder",
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=1024, vocab_size=8192,
    norm="layernorm", act="gelu", gated_mlp=False, abs_pos=True,
    attn=AttnConfig(rope_base=None),
    max_seq_len=128,
)
