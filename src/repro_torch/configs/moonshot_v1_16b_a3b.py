"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (kv=16, the fused wqkv layout) vocab=163840, rotary
embeddings (base 5e4), an untied head; 64 routed experts, top-6, expert
d_ff=1408, and 2 shared experts (DeepSeek-V3 style). The port serves it
in decoder mode.

SMOKE is the variant the CPU tests serve.
"""
from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", arch_type="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163_840,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  expert_d_ff=1408),
    attn=AttnConfig(rope_base=50_000.0),
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke", arch_type="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                  expert_d_ff=512),
    attn=AttnConfig(rope_base=50_000.0),
)
