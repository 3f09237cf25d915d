"""Configuration of DeepSeek-V3-style decoders: multi-head latent attention,
leading dense layers, and sigmoid-scored routing.

A port-only module: the shared :class:`ModelConfig` is a copy of the JAX
package's and holds none of these fields. :class:`LatentConfig` adds them
with defaults, so a plain ``ModelConfig``'s fields and behaviour are
unchanged, and the model code asks :func:`is_latent` before it reads them.

* MLA [arXiv:2405.04434 §2.1], without a query low-rank path: per head a
  query of ``qk_nope_head_dim + qk_rope_head_dim`` columns; the key and the
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
"""
from __future__ import annotations

from dataclasses import dataclass

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
