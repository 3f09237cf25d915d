"""Nemotron-4 15B [arXiv:2402.16819].

[dense] 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 — GQA,
squared-ReLU MLP (non-gated, 2 matrices).
"""
from repro_torch.configs.base import ModelConfig, DENSE, ACT_SQ_RELU

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b",
    family=DENSE,
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    activation=ACT_SQ_RELU,
    use_bias=False,
    norm="layernorm",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512,
    )
