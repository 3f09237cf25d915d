"""Kimi K2 — trillion-parameter MoE (paper-table config) [arXiv:2501.kimi2].

[moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384 experts top-8 + 1 shared expert (DeepSeek-V3-style).
Assignment specifies GQA kv=8 (we follow it; the real model uses MLA).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MOE, ACT_SILU

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family=MOE,
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,                  # shared-expert dense path
    vocab_size=163840,
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=384, top_k=8, expert_d_ff=2048,
                  capacity_factor=1.25, group_size=2048),
    source="arXiv:2501.kimi2",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=256, group_size=64),
    )
