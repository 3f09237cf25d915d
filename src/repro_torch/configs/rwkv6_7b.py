"""RWKV-6 "Finch" 7B [arXiv:2404.05892].

[ssm] 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536 —
data-dependent decay linear attention (time-mix) + gated channel-mix.
Heads of size 64 → 64 heads. Decode state is O(H·dh²) per layer — constant in
sequence length, so ``long_500k`` runs natively.
"""
from repro_torch.configs.base import ModelConfig, SSM

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family=SSM,
    num_layers=32,
    d_model=4096,
    num_heads=64,                # rwkv6 head size 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    use_bias=False,
    norm="layernorm",
    pos_emb="none",              # recurrence encodes position
    source="arXiv:2404.05892",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512,
    )
