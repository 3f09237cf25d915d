"""Qwen2-VL-72B language backbone [arXiv:2409.12191].

[vlm] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 — M-RoPE,
dynamic resolution. Vision encoder (ViT) is a STUB per the assignment: the
backbone consumes precomputed patch embeddings supplied by ``input_specs``.
"""
from repro_torch.configs.base import ModelConfig, VLM, ACT_SILU

CONFIG = ModelConfig(
    arch_id="qwen2-vl-72b",
    family=VLM,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    pos_emb="mrope",            # multimodal RoPE: (temporal, height, width)
    rope_theta=1_000_000.0,
    vision_prefix_len=256,      # stub patch-embedding positions in training
    source="arXiv:2409.12191",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, vision_prefix_len=8,
    )
