"""Moonlight-16B-A3B as published [hf:moonshotai/Moonlight-16B-A3B,
config.json; arXiv:2502.16982]: DeepSeek-V3's block at d_model 2048.

27 layers, 16 heads of MLA without a query low-rank path (kv_lora_rank 512,
nope/rope/v head dims 128/64/128, softmax scale 1/sqrt(192)); layer 0 a
dense SwiGLU of 11264; layers 1-26 each 64 routed experts of 1408 (top 6,
sigmoid scores with a selection-only bias, one group, gates normalised and
scaled by 2.446) plus 2 shared experts, one SwiGLU of 2816; rope theta
50000 without scaling; RMSNorm eps 1e-5; vocab 163840, untied; 8192
positions. 15.96 B parameters.

Not in ``ARCH_IDS``, which equals the JAX package's registry:
``get_config("moonlight_16b_a3b")`` finds this module by name.
``moonshot_v1_16b_a3b`` is the registry's GQA stand-in under the same
name.
"""
from repro_torch.configs.base import ACT_SILU, MOE, MoEConfig
from repro_torch.configs.latent import SIGMOID, LatentConfig

CONFIG = LatentConfig(
    arch_id="moonlight-16b-a3b",
    family=MOE,
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,                # the value head's width
    d_ff=2816,                   # the 2 shared experts as one SwiGLU
    vocab_size=163840,
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408,
                  capacity_factor=1.25, group_size=2048),
    max_seq_len=8192,
    source="hf:moonshotai/Moonlight-16B-A3B",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    dense_d_ff=11264,
    scoring=SIGMOID,
    routed_scaling_factor=2.446,
)


def smoke_config() -> LatentConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=48, vocab_size=512, dense_d_ff=96, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe=MoEConfig(num_experts=8, top_k=3, expert_d_ff=32, group_size=64),
        max_seq_len=1024)
