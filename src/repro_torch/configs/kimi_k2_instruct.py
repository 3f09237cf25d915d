"""Kimi-K2-Instruct [hf:moonshotai/Kimi-K2-Instruct, config.json;
arXiv:2507.20534]: DeepSeek-V3's block at d_model 7168, cut to one H100's
share of an eight-chip expert-parallel stage.

As published: 61 layers, 64 heads of MLA with a query low-rank path
(q_lora_rank 1536, kv_lora_rank 512, nope/rope/v head dims 128/64/128);
layer 0 a dense SwiGLU of 18432; layers 1-60 each 384 routed experts of
2048 (top 8, sigmoid scores with a selection-only bias, one group, gates
normalised and scaled by 2.827) plus 1 shared expert of 2048; rope theta
50000 under YaRN (factor 32, beta_fast 1, beta_slow 1, mscale 1,
mscale_all_dim 1, 4096 original positions: softmax scale 1/sqrt(192)
times 1.8133); RMSNorm eps 1e-6; vocab 163840, untied; 131072 positions.
1.04 T parameters.

The deployment: data-parallel attention and expert parallelism over one
8-GPU node (EP8), each chip all 64 heads for its own requests and 48 of
each MoE layer's 384 experts, the vocabulary split over the same 8 chips;
the 60 MoE layers as 6 pipeline stages of 10 (48 chips). This chip is
stage 1's share: the dense layer 0 and MoE layers 1-10 (11 layers), routed
experts 0-47 (``experts_held``; the router still scores all 384 and the
capacity is reckoned over all of them), vocabulary rows 0-20479, the
embedding and the output head on the chip. Every width as published.
23.41 B parameters (46.8 GB in bf16).

Not in ``ARCH_IDS``, which equals the JAX package's registry:
``get_config("kimi_k2_instruct")`` finds this module by name.
``kimi_k2_1t_a32b`` is the registry's GQA stand-in.
"""
from repro_torch.configs.base import ACT_SILU, MOE, MoEConfig
from repro_torch.configs.latent import SIGMOID, LatentConfig

CONFIG = LatentConfig(
    arch_id="kimi-k2-instruct",
    family=MOE,
    num_layers=11,               # of 61: layer 0 and MoE layers 1-10
    d_model=7168,
    num_heads=64,
    num_kv_heads=64,
    head_dim=128,                # the value head's width
    d_ff=2048,                   # the 1 shared expert
    vocab_size=20480,            # of 163840: this chip's eighth
    activation=ACT_SILU,
    use_bias=False,
    norm="rmsnorm",
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=384, top_k=8, expert_d_ff=2048,
                  capacity_factor=1.25, group_size=2048),
    max_seq_len=131072,
    source="hf:moonshotai/Kimi-K2-Instruct",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    dense_d_ff=18432,
    scoring=SIGMOID,
    routed_scaling_factor=2.827,
    q_lora_rank=1536,
    rope_factor=32.0,
    rope_original_max=4096,
    rope_beta_fast=1.0,
    rope_beta_slow=1.0,
    rope_mscale=1.0,
    rope_mscale_all_dim=1.0,
    norm_eps=1e-6,
    experts_held=48,             # of 384: experts 0-47
)


def smoke_config() -> LatentConfig:
    """Kimi's shape at smoke widths: the query path, YaRN (rope pairs 0-1
    kept, 3 slowed 32x), 4 heads, 16 experts of which 2 are held (one of
    8 shares)."""
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512, dense_d_ff=96, kv_lora_rank=32,
        q_lora_rank=24, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, experts_held=2,
        moe=MoEConfig(num_experts=16, top_k=4, expert_d_ff=32, group_size=64),
        max_seq_len=1024)
