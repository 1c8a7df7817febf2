"""StableLM-2-12B family.

40L d_model=5120 32H (GQA kv=8, head_dim 160) d_ff=13824 vocab=100352,
LayerNorm, rotary embeddings (base 1e4), SwiGLU, an untied lm head. Eight
kv heads take the split q/k/v layout. The port serves it in decoder
mode.

SMOKE is the variant the CPU tests serve.
"""
from repro_torch.models.config import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13_824, vocab_size=100_352,
    norm="layernorm",
    attn=AttnConfig(rope_base=10_000.0),
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke", arch_type="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    norm="layernorm",
    attn=AttnConfig(rope_base=10_000.0),
)
