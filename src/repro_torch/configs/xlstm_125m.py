"""xLSTM-125M [arXiv:2405.04517].

12L d_model=768 4H, vocab=50304, d_ff=0 (the blocks carry their own
projections). A 5:1 mLSTM:sLSTM ratio: a pattern of five mLSTM blocks and
one sLSTM block, two periods. Attention-free: decode carries recurrent
states, not a KV cache. The port serves it in decoder mode and trains it.

SMOKE is the variant the CPU tests serve.
"""
from repro_torch.models.config import AttnConfig, ModelConfig

_PATTERN = ("mlstm",) * 5 + ("slstm",)

CONFIG = ModelConfig(
    name="xlstm-125m", arch_type="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    pattern=_PATTERN,
    attn=AttnConfig(rope_base=None),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke", arch_type="ssm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=512,
    pattern=("mlstm", "slstm"),
    attn=AttnConfig(rope_base=None),
    tie_embeddings=True,
)
