"""Public model API: the LM loss and example batches.

Port of ``repro/models/model.py`` for the families the port runs. The loss
runs the training forward (``forward_seq`` on the plain, differentiable
attention). ``build`` and ``ModelBundle`` wait for ROADMAP item A8's
example twin; ``batch_spec`` and ``decode_specs`` are the reference's
dry-run tooling and wait for item A13.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import VLM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Masked token-mean CE in f32. logits: (B,S,V); targets/mask: (B,S).

    The gold logit is gathered (the reference selects it with a one-hot
    einsum, for vocab sharding; the value is the same)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, attn_impl: str = "chunked", remat: str = "full",
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``(loss, metrics)``: token-mean CE plus the auxiliary losses (the
    MoE family's load-balance and router z-losses, zero for the others);
    metrics hold ``ce`` and each aux. A VLM batch's ``vision_embeds`` and
    ``mrope_positions`` go to the forward."""
    logits, _, aux = tfm.forward_seq(
        params, cfg, batch["tokens"],
        vision_embeds=batch.get("vision_embeds"),
        mrope_positions=batch.get("mrope_positions"),
        attn_impl=attn_impl, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["loss_mask"])
    loss = ce + aux["load_balance_loss"] + aux["router_z_loss"]
    return loss, {"ce": ce, **aux}


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
    ``mrope_positions`` (3, batch, seq)."""
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
    return {**out, "targets": ids(seq), "loss_mask": mask}
