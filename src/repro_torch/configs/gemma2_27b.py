"""Gemma-2-27B [arXiv:2408.00118].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128,
alternating local (window 4096) and global attention, attention logit
softcap 50, final logit softcap 30, post-norms, GeGLU, tied embeddings
scaled by sqrt(d_model). Sixteen kv heads take the fused ``wqkv`` layout
(``ModelConfig.fused_qkv``). The port serves it in decoder mode.

``long_ctx`` runs the windowed-global variant: the global layers' caches
and windows are capped at ``attn.long_ctx_window_cap`` = 32768 slots.

SMOKE is the variant the CPU tests serve (4 kv heads: not fused).
"""
from repro_torch.models.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", arch_type="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36_864, vocab_size=256_000, head_dim=128,
    pattern=("attn_local", "attn_global"),
    act="gelu", post_norms=True, tie_embeddings=True, embed_scale=True,
    final_logit_softcap=30.0,
    attn=AttnConfig(window=4096, logit_softcap=50.0, rope_base=10_000.0,
                    long_ctx_window_cap=32_768),
)

SMOKE = ModelConfig(
    name="gemma2-27b-smoke", arch_type="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=512, vocab_size=512, head_dim=32,
    pattern=("attn_local", "attn_global"),
    act="gelu", post_norms=True, tie_embeddings=True, embed_scale=True,
    final_logit_softcap=30.0,
    attn=AttnConfig(window=64, logit_softcap=50.0, rope_base=10_000.0,
                    long_ctx_window_cap=128),
)
