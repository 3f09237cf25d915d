"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

[dense] 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — GQA, no-bias.
Command-R uses LayerNorm (no bias) and parallel attn/MLP blocks; we keep the
sequential pre-norm block (the scheduling study is insensitive to this) but
keep the published LayerNorm choice.
"""
from repro_torch.configs.base import ModelConfig, DENSE, ACT_SILU

CONFIG = ModelConfig(
    arch_id="command-r-35b",
    family=DENSE,
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    activation=ACT_SILU,
    use_bias=False,
    norm="layernorm",
    rope_theta=8_000_000.0,
    tie_embeddings=True,        # Command-R ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-v01",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512,
    )
