"""Hymba-1.5B [arXiv:2411.13676].

[hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16 —
parallel attention + Mamba heads fused in every layer. Hymba uses sliding-
window attention in most layers; we set window=1024 so the attention-side KV
cache is bounded and ``long_500k`` runs natively (the SSM side is O(1)/token).
Meta-tokens are omitted (orthogonal to the scheduling study — DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, HYBRID, ACT_SILU

CONFIG = ModelConfig(
    arch_id="hymba-1.5b",
    family=HYBRID,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    rope_theta=10_000.0,
    sliding_window=1024,
    ssm=SSMConfig(state_size=16, conv_width=4, expand=2, head_dim=64,
                  chunk_size=128),
    source="arXiv:2411.13676",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, sliding_window=64,
        ssm=SSMConfig(state_size=16, conv_width=4, expand=2, head_dim=64,
                      chunk_size=32),
    )
