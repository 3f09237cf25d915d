"""Whisper-tiny [arXiv:2212.04356].

[audio] 4L d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865 — encoder-decoder
with conv/mel frontend STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings (1500 frames after the conv stride-2 stack).
Skipped for ``long_500k`` (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, AUDIO, ACT_GELU

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family=AUDIO,
    num_layers=4,                # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    activation=ACT_GELU,
    use_bias=True,
    norm="layernorm",
    pos_emb="learned",
    tie_embeddings=True,
    encoder_layers=4,
    encoder_seq_len=1500,        # 30 s audio → 1500 post-conv frames
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, encoder_layers=2, encoder_seq_len=64,
    )
