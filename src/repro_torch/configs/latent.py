"""Configuration of DeepSeek-V3-style decoders: multi-head latent attention,
leading dense layers, and sigmoid-scored routing.

A port-only module: the shared :class:`ModelConfig` is a copy of the JAX
package's and holds none of these fields. :class:`LatentConfig` adds them
with defaults, so a plain ``ModelConfig``'s fields and behaviour are
unchanged, and the model code asks :func:`is_latent` before it reads them.

* MLA [arXiv:2405.04434 §2.1]: per head a query of ``qk_nope_head_dim +
  qk_rope_head_dim`` columns, straight from the input (``q_lora_rank`` 0)
  or through a query low-rank path of ``q_lora_rank`` columns, RMS-normed
  between its two products (DeepSeek-V3, Kimi K2); the key and the
  value come from one latent ``c_kv`` of ``kv_lora_rank`` columns (RMS-normed)
  up-projected per head to ``qk_nope_head_dim`` key and ``v_head_dim`` value
  columns, beside one rotary key of ``qk_rope_head_dim`` columns shared by
  every head. The decode cache keeps ``[c_kv | k_pe]`` a token a layer.
* The first ``first_k_dense`` layers hold a dense SwiGLU MLP of
  ``dense_d_ff`` in place of the experts; the rest are MoE layers whose
  shared experts are the ``d_ff`` MLP.
* The router [arXiv:2412.19437 §2.1.2]: ``scoring="sigmoid"`` scores each
  expert by a sigmoid, picks the top k of the scores plus a per-expert bias
  (selection only), and gates by the chosen scores, normalised over the k,
  times ``routed_scaling_factor``. ``"softmax"`` is the router every other
  MoE configuration runs.
* YaRN [arXiv:2309.00071], as DeepSeek-V3's ``DeepseekV3YarnRotaryEmbedding``
  computes it, where ``rope_factor`` exceeds 1: the rope frequencies past
  the ramp from ``rope_beta_fast`` to ``rope_beta_slow`` rotations over
  ``rope_original_max`` positions are slowed ``rope_factor`` times, and the
  softmax scale is multiplied by ``mscale(rope_factor,
  rope_mscale_all_dim)^2`` (:func:`yarn`).
* ``norm_eps``: every RMSNorm's epsilon.
* ``experts_held``: the routed experts this chip holds, the first
  ``experts_held`` of ``moe.num_experts`` (0: all). The router scores and
  chooses over all of them, capacity is reckoned over all of them, and the
  layer adds only its own experts' part: one chip's share of an
  expert-parallel deployment.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

from repro_torch.configs.base import ModelConfig

SOFTMAX = "softmax"
SIGMOID = "sigmoid"


@dataclass(frozen=True)
class LatentConfig(ModelConfig):
    kv_lora_rank: int = 0            # 0: the attention is not latent
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    first_k_dense: int = 0           # leading layers with a dense MLP
    dense_d_ff: int = 0              # ... of this width
    scoring: str = SOFTMAX
    routed_scaling_factor: float = 1.0
    q_lora_rank: int = 0             # 0: the query comes straight from x
    rope_factor: float = 1.0         # YaRN's scaling; 1: plain rope
    rope_original_max: int = 0       # YaRN: the pre-training context
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    norm_eps: float = 1e-5
    experts_held: int = 0            # 0: every routed expert

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Columns of one cached latent row: ``[c_kv | k_pe]``."""
        return self.kv_lora_rank + self.qk_rope_head_dim


def is_latent(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s attention is MLA over a latent cache."""
    return getattr(cfg, "kv_lora_rank", 0) > 0


def dense_layers(cfg: ModelConfig) -> int:
    """Leading layers that hold a dense MLP in place of the experts."""
    return getattr(cfg, "first_k_dense", 0)


def norm_eps(cfg: ModelConfig) -> float:
    """The epsilon of ``cfg``'s RMSNorms (1e-5 where the config names
    none)."""
    return getattr(cfg, "norm_eps", 1e-5)


def experts_held(cfg: ModelConfig) -> int:
    """The routed experts ``cfg``'s MoE layers hold: ``experts_held``, or
    every one."""
    return getattr(cfg, "experts_held", 0) or cfg.moe.num_experts


class Yarn(NamedTuple):
    """YaRN's frequency ramp over the rope's frequency pairs: pairs below
    ``low`` keep their frequency, pairs from ``high`` on are slowed
    ``factor`` times, linearly between; ``rope_scale`` multiplies cos and
    sin, ``softmax_scale`` the softmax's ``1/sqrt(qk head dim)``."""
    low: float
    high: float
    factor: float
    rope_scale: float
    softmax_scale: float


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(cfg: ModelConfig) -> Yarn:
    """DeepSeek-V3's YaRN of ``cfg`` (``rope_factor`` > 1): the correction
    range ``floor(corr(beta_fast)), ceil(corr(beta_slow))``, ``corr(n) =
    dr ln(original / (2 pi n)) / (2 ln theta)``, clamped to the rope's
    columns (``high`` 0.001 past ``low`` where they meet)."""
    dr, theta = cfg.qk_rope_head_dim, cfg.rope_theta

    def corr(rotations: float) -> float:
        return (dr * math.log(cfg.rope_original_max
                              / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(corr(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(corr(cfg.rope_beta_slow)), dr - 1)
    if low == high:
        high += 0.001
    f = cfg.rope_factor
    return Yarn(low, high, f,
                _mscale(f, cfg.rope_mscale)
                / _mscale(f, cfg.rope_mscale_all_dim),
                _mscale(f, cfg.rope_mscale_all_dim) ** 2
                if cfg.rope_mscale_all_dim else 1.0)


def yarn_of(cfg: ModelConfig):
    """:func:`yarn` where ``cfg`` scales its rope, else None."""
    return yarn(cfg) if getattr(cfg, "rope_factor", 1.0) > 1 else None
