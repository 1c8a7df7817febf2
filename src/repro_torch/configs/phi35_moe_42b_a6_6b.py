"""Phi-3.5-MoE-instruct [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) vocab=32064, LayerNorm, rotary
embeddings (base 1e4), an untied head; 16 experts, top-2, expert
d_ff=6400, no shared experts. The port serves it in decoder mode; its
84 GB of bf16 weights do not fit one H100 whole.

SMOKE is the variant the CPU tests serve.
"""
from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32_064,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=6400),
    norm="layernorm",
    attn=AttnConfig(rope_base=10_000.0),
)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b-smoke", arch_type="moe",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=512),
    norm="layernorm",
    attn=AttnConfig(rope_base=10_000.0),
)
