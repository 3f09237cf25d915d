"""OLMoE-1B-7B [arXiv:2409.02060].

[moe] 16L d_model=2048 16H (GQA kv=16 → MHA) d_ff=1024 vocab=50304,
MoE 64 experts top-8 (no shared expert).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MOE, ACT_SILU

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family=MOE,
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                     # no shared dense FFN path
    vocab_size=50304,
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=8, expert_d_ff=1024),
    source="arXiv:2409.02060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=256, group_size=64),
    )
