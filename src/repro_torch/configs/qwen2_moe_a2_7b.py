"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16, the fused wqkv layout) vocab=151936, QKV
bias, rotary embeddings (base 1e6), an untied head; 60 routed experts,
top-4, expert d_ff=1408, and 4 shared experts fused to one MLP of width
4 x 1408 = 5632. The port serves it in decoder mode.

SMOKE is the variant the CPU tests serve.
"""
from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", arch_type="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=151_936,
    moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=4,
                  expert_d_ff=1408),
    attn=AttnConfig(qkv_bias=True, rope_base=1e6),
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", arch_type="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=2,
                  expert_d_ff=512),
    attn=AttnConfig(qkv_bias=True, rope_base=1e6),
)
