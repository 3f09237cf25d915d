"""Moonshot Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

Assignment pool label is [dense] but the spec line explicitly lists
"MoE 64e top-6" — we implement the explicit expert spec (DESIGN.md §5):
48L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=163840,
MoE 64 experts top-6 + shared dense path (DeepSeek-V3-style).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MOE, ACT_SILU

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family=MOE,
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                  # shared-expert dense path
    vocab_size=163840,
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  capacity_factor=1.25, group_size=2048),
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=256, group_size=64),
    )
