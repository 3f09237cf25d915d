"""Model / input-shape configuration system.

Every assigned architecture gets one ``<arch_id>.py`` module in this package
exporting ``CONFIG`` (a :class:`ModelConfig` at the exact published size) and
``smoke_config()`` (a reduced same-family variant for CPU tests).

The config is a plain frozen dataclass — no framework magic — so it can be
hashed into jit static args and printed into experiment logs verbatim.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"          # attention-free (RWKV6)
HYBRID = "hybrid"    # parallel attention + SSM heads (Hymba)
VLM = "vlm"          # decoder LM consuming stub patch embeddings
AUDIO = "audio"      # encoder-decoder consuming stub frame embeddings

FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO)

# Activation functions understood by models/layers.py
ACT_SILU = "silu"            # gated SiLU (SwiGLU)
ACT_SQ_RELU = "squared_relu" # Nemotron-4
ACT_GELU = "gelu"            # whisper / BERT-style


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts block configuration (GLaM-style grouped dispatch)."""
    num_experts: int
    top_k: int
    expert_d_ff: int            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    group_size: int = 2048      # tokens per dispatch group (sharding grain)
    router_z_coef: float = 1e-3 # router z-loss
    aux_loss_coef: float = 1e-2 # load-balance loss


@dataclass(frozen=True)
class SSMConfig:
    """SSD/Mamba2-style selective-state-space configuration."""
    state_size: int = 16        # N — per-channel state width
    conv_width: int = 4         # depthwise conv kernel (decode keeps a tail)
    expand: int = 2             # d_inner = expand * d_model
    head_dim: int = 64          # SSD head dim
    chunk_size: int = 128       # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    """One architecture, exactly as published (or its reduced smoke variant)."""
    arch_id: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free)
    num_kv_heads: int            # GQA kv heads
    d_ff: int                    # dense-MLP hidden (MoE archs: shared/dense path, 0 if none)
    vocab_size: int
    head_dim: int = 128
    activation: str = ACT_SILU
    use_bias: bool = False
    norm: str = "rmsnorm"        # or "layernorm"
    tie_embeddings: bool = False

    # Positional encoding: "rope" | "mrope" (Qwen2-VL) | "learned" | "none"
    pos_emb: str = "rope"
    rope_theta: float = 500_000.0

    # Attention window: None = full causal. Set (or auto-set for long_500k)
    # to make attention sub-quadratic with a bounded KV cache.
    sliding_window: Optional[int] = None

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # Encoder-decoder (whisper): encoder layer count + fixed source length.
    encoder_layers: int = 0
    encoder_seq_len: int = 0     # e.g. 1500 mel frames after conv stub

    # VLM: number of stub patch-embedding positions prepended in training.
    vision_prefix_len: int = 0

    max_seq_len: int = 1_048_576
    dtype: str = "bfloat16"
    source: str = ""             # citation from the assignment table

    # ---- derived ---------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if not self.attention_free:
            qkv = d * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
            o = self.num_heads * self.head_dim * d
            per_layer += qkv + o
        else:
            # rwkv6 time-mix: r,k,v,g,o (d*d each) + decay/ lora-ish small
            per_layer += 5 * d * d
        if self.moe is not None:
            e = self.moe
            per_layer += e.num_experts * (3 * d * e.expert_d_ff) + d * e.num_experts
            if self.d_ff:
                per_layer += 3 * d * self.d_ff          # shared dense path
        elif self.family == SSM:
            per_layer += 3 * d * self.d_ff              # rwkv channel-mix ~ gated mlp
        else:
            mult = 3 if self.activation == ACT_SILU else 2
            per_layer += mult * d * self.d_ff
        if self.ssm is not None and self.family == HYBRID:
            d_in = self.ssm.expand * d
            per_layer += 2 * d * d_in + d_in * d + d_in * (2 * self.ssm.state_size)
        n += self.num_layers * per_layer
        if self.is_encdec:
            enc_layer = 4 * d * self.num_heads * self.head_dim + 2 * d * self.d_ff
            n += self.encoder_layers * enc_layer
            # decoder cross-attention
            n += self.num_layers * 4 * d * self.num_heads * self.head_dim
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        dense = self.param_count() - self.num_layers * e.num_experts * 3 * self.d_model * e.expert_d_ff
        return int(dense + self.num_layers * e.top_k * 3 * self.d_model * e.expert_d_ff)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

# Window applied to full-attention archs when running long_500k (DESIGN.md §5).
LONG_CONTEXT_WINDOW = 8_192


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """Whether (arch, shape) is part of the dry-run matrix (DESIGN.md §5)."""
    if shape.name == "long_500k" and cfg.family == AUDIO:
        return False  # whisper: no sub-quadratic variant in family — skipped
    return True


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt a config to an input shape (sliding-window for long_500k)."""
    if shape.name == "long_500k" and not cfg.attention_free and cfg.sliding_window is None:
        return cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
ARCH_IDS = (
    "qwen2_vl_72b",
    "command_r_35b",
    "nemotron_4_15b",
    "olmoe_1b_7b",
    "llama3_2_3b",
    "kimi_k2_1t_a32b",
    "hymba_1_5b",
    "whisper_tiny",
    "moonshot_v1_16b_a3b",
    "rwkv6_7b",
)

# CLI ids (dashes) -> module ids (underscores)
def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{canon(arch)}")
    return mod.smoke_config()


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
