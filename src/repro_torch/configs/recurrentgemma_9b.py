"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000.
RG-LRU + local attention at 1:2 attention:recurrent ratio; 38 = 2 periods of
a 19-block pattern (six (rec,rec,attn) triples + one trailing rec). Local
window 2048. Gated GeLU MLP, tied embeddings scaled by sqrt(d_model). The
port serves it in decoder mode, batch at a time.

SMOKE is the variant the CPU tests serve.
"""
from repro_torch.models.config import AttnConfig, ModelConfig

_PATTERN = ("rglru", "rglru", "attn_local") * 6 + ("rglru",)

CONFIG = ModelConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12_288, vocab_size=256_000, head_dim=256,
    pattern=_PATTERN,
    act="gelu", tie_embeddings=True, embed_scale=True,
    attn=AttnConfig(window=2048, rope_base=10_000.0),
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", arch_type="hybrid",
    n_layers=3, d_model=256, n_heads=4, n_kv_heads=1,
    d_ff=512, vocab_size=512, head_dim=64,
    pattern=("rglru", "rglru", "attn_local"),
    act="gelu", tie_embeddings=True, embed_scale=True,
    attn=AttnConfig(window=64, rope_base=10_000.0),
)
