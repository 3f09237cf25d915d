"""Llama 3.2 3B [hf:meta-llama/Llama-3.2-1B family].

[dense] 28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256 — small llama3.
"""
from repro_torch.configs.base import ModelConfig, DENSE, ACT_SILU

CONFIG = ModelConfig(
    arch_id="llama3.2-3b",
    family=DENSE,
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512,
    )
