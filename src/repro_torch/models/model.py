"""Public model API: build, the LM loss, prefill/decode entry points and
example batches.

Port of ``repro/models/model.py``. :func:`build` bundles a config's
callables as the reference's does: the loss runs the training route
(``forward_seq`` on the plain, differentiable attention and scan), prefill
and decode run the kernels. ``batch_spec`` and ``decode_specs`` are the
dry-run's inputs (``launch/dryrun.py``): shape-only ``meta`` tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (AUDIO, VLM, InputShape, ModelConfig,
                                      config_for_shape)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.sharding.annotate import splits, with_sharding

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked token-mean CE in f32. logits: (B,S,V); targets/mask: (B,S).

    The gold logit is gathered. Where sharding rules split the vocab dim it
    is selected, as the reference always selects it, with a one-hot einsum,
    which keeps that dim split (a gather over it would all-gather the f32
    logits); the value is the same."""
    lf = with_sharding(logits.float(), ("batch", None, "vocab"))
    lse = torch.logsumexp(lf, dim=-1)
    if not splits("vocab", lf.shape[-1]):
        gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    else:
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        onehot = (targets.long()[..., None] == vocab).float()
        onehot = with_sharding(onehot, ("batch", None, "vocab"))
        gold = torch.einsum("bsv,bsv->bs", lf, onehot)
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, attn_impl: str = "chunked", remat: str = "full",
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``(loss, metrics)``: token-mean CE plus the auxiliary losses (the
    MoE family's load-balance and router z-losses, zero for the others);
    metrics hold ``ce`` and each aux. A VLM batch's ``vision_embeds`` and
    ``mrope_positions``, and an audio batch's ``frames``, go to the
    forward."""
    logits, _, aux = tfm.forward_seq(
        params, cfg, batch["tokens"],
        vision_embeds=batch.get("vision_embeds"),
        mrope_positions=batch.get("mrope_positions"),
        frames=batch.get("frames"),
        attn_impl=attn_impl, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["loss_mask"])
    loss = ce + aux["load_balance_loss"] + aux["router_z_loss"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Params]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict]]
    prefill: Callable[..., Tuple[torch.Tensor, tfm.Cache]]
    decode_step: Callable[..., Tuple[torch.Tensor, tfm.Cache]]
    init_cache: Callable[..., tfm.Cache]


def build(cfg: ModelConfig, *, attn_impl: str = "chunked",
          remat: str = "full") -> ModelBundle:
    """The reference's bundle of a config's callables:

    * ``init(seed=0, *, device="cuda", param_dtype=None)``: parameters;
    * ``loss_fn(params, batch)``: :func:`lm_loss` on the training route
      (``attn_impl``, ``"naive"`` or ``"chunked"``, and ``remat``);
    * ``prefill(params, tokens, cache_len, **extras)``: ``(logits, cache)``
      of ``forward_seq`` on the kernels, building a fresh cache of
      ``cache_len`` positions (``extras``: ``frames``, ``vision_embeds``,
      ``mrope_positions``);
    * ``decode_step(params, cache, token)``: ``(logits (B, V), cache)``;
    * ``init_cache(batch, max_len, pos=0, dtype=None, *, device="cuda")``:
      an empty contiguous or paged cache with every row at ``pos``."""
    tfm.check_supported(cfg)
    if attn_impl not in ("naive", "chunked"):
        raise ValueError(f"attn_impl={attn_impl!r}: the loss runs 'naive' "
                         f"or 'chunked' (the kernels have no backward)")

    def init(seed: int = 0, *, device: DeviceLike = "cuda",
             param_dtype: Optional[torch.dtype] = None) -> Params:
        return tfm.init_params(cfg, seed, device=device,
                               param_dtype=param_dtype)

    def loss_fn(params, batch):
        return lm_loss(params, cfg, batch, attn_impl=attn_impl, remat=remat)

    def prefill(params, tokens, cache_len, **extras):
        logits, cache, _ = tfm.forward_seq(
            params, cfg, tokens, build_cache=True, cache_len=cache_len,
            attn_impl="kernel", **extras)
        return logits, cache

    def decode_step(params, cache, token):
        return tfm.decode_step(params, cfg, cache, token)

    def init_cache(batch, max_len, pos=0, dtype=None, *,
                   device: DeviceLike = "cuda"):
        cache = tfm.init_cache(cfg, batch, max_len, dtype=dtype,
                               device=device)
        cache["pos"].fill_(pos)
        return cache

    return ModelBundle(cfg, init, loss_fn, prefill, decode_step, init_cache)


# ---------------------------------------------------------------------------
# Input specs
# ---------------------------------------------------------------------------
def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_spec(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Training/prefill batch of (arch × input shape) as ``meta`` tensors:
    int32 ``tokens`` and ``targets``, an f32 ``loss_mask``; the VLM
    family's ``vision_embeds`` (B, P, d) take the first P positions and
    ``mrope_positions`` (3, B, S) are int32; the audio family adds
    ``frames`` (B, encoder_seq_len, d) in the activation dtype."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    spec: Dict[str, torch.Tensor] = {}
    if cfg.family == VLM:
        p = cfg.vision_prefix_len
        spec["tokens"] = _meta((b, s - p), i32)
        spec["vision_embeds"] = _meta((b, p, cfg.d_model), _act_dtype(cfg))
        spec["mrope_positions"] = _meta((3, b, s), i32)
    elif cfg.family == AUDIO:
        spec["tokens"] = _meta((b, s), i32)
        spec["frames"] = _meta((b, cfg.encoder_seq_len, cfg.d_model),
                               _act_dtype(cfg))
    else:
        spec["tokens"] = _meta((b, s), i32)
    spec["targets"] = _meta((b, s), i32)
    spec["loss_mask"] = _meta((b, s), torch.float32)
    return spec


def decode_specs(cfg: ModelConfig, shape: InputShape):
    """``(cache, token)`` of a decode-shape dry-run as ``meta`` tensors:
    the contiguous cache of ``global_batch`` rows and ``seq_len``
    positions (the reference's layout is contiguous) and an int32 (B, 1)
    token."""
    cfg = config_for_shape(cfg, shape)
    b = shape.global_batch
    cache = tfm.init_cache(cfg, b, shape.seq_len, paged=False,
                           device="meta")
    return cache, _meta((b, 1), torch.int32)


# ---------------------------------------------------------------------------
# Example batches
# ---------------------------------------------------------------------------
def example_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0, *,
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """A random batch of ``seq`` positions: ``tokens`` and ``targets``
    uniform over the vocabulary and a ones ``loss_mask``, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``. For the VLM
    family, as the reference: the first ``vision_prefix_len`` positions
    are ``vision_embeds`` (normal, times 0.02, in the model's dtype) in
    place of tokens, masked out of the loss, with linear
    ``mrope_positions`` (3, batch, seq). For the audio family, ``frames``
    (batch, encoder_seq_len, d_model), normal times 0.02 in the model's
    dtype."""
    tfm.check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = cfg.vision_prefix_len if cfg.family == VLM else 0

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                             device=dev)
    out = {"tokens": ids(seq - p)}
    mask = torch.ones(batch, seq, device=dev)
    if p:
        out["vision_embeds"] = (torch.randn(
            batch, p, cfg.d_model, generator=gen, device=dev) * 0.02).to(
                getattr(torch, cfg.dtype))
        out["mrope_positions"] = torch.arange(
            seq, dtype=torch.int32, device=dev).expand(3, batch, seq)
        mask[:, :p] = 0
    if cfg.family == AUDIO:
        out["frames"] = (torch.randn(
            batch, cfg.encoder_seq_len, cfg.d_model, generator=gen,
            device=dev) * 0.02).to(getattr(torch, cfg.dtype))
    return {**out, "targets": ids(seq), "loss_mask": mask}
