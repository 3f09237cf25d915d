"""Chunked linear attention with per-step (data-dependent) decay: plain
PyTorch.

Port of ``repro/models/linear_attn.py``. One engine serves two recurrences:

* ``mode="rwkv"`` (RWKV-6 time-mix)::

      S_t = diag(w_t) S_{t-1} + k_t v_t^T
      o_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t        (u = bonus)

  with a vector decay ``w_t`` per step;
* ``mode="ssd"`` (Mamba-2 / SSD, the Hymba SSM heads)::

      S_t = a_t S_{t-1} + k_t v_t^T                     (scalar decay a_t)
      o_t = q_t S_t

Both are computed in chunks: intra-chunk through a decay-weighted attention
matrix, inter-chunk through the carried f32 state; all decay algebra runs in
f32 log space. These functions are the plain version and the oracle of the
chunked kernel (``kernels/rwkv6_chunk``).

NUMERICS CONTRACT: callers clamp the per-step log-decay to
``[-MAX_LOG_DECAY, 0]``; with ``chunk_size * MAX_LOG_DECAY <= 80`` the
intra-chunk exponentials stay inside the f32 range.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

MAX_LOG_DECAY = 1.0  # per-step |log w| bound enforced by callers


def _chunk(x: torch.Tensor, c: int) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.reshape(b, h, t // c, c, d)


def chunked_linear_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_decay: torch.Tensor, *, bonus: Optional[torch.Tensor] = None,
        mode: str = "rwkv", chunk_size: int = 64,
        initial_state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, H, T, dk); v: (B, H, T, dv); log_decay: (B, H, T, dk)
    vector or (B, H, T, 1) scalar; bonus: (H, dk) (``rwkv`` only);
    initial_state: (B, H, dk, dv) f32.

    Returns ``(out (B, H, T, dv) in q.dtype, final_state (B, H, dk, dv)
    f32)``."""
    if mode not in ("rwkv", "ssd"):
        raise ValueError(f"mode must be 'rwkv' or 'ssd', got {mode!r}")
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk_size, t)
    if t % c:
        raise ValueError(f"T={t} not divisible by chunk_size={c}")
    f32 = torch.float32
    qf, kf, vf = (_chunk(x.to(f32), c) for x in (q, k, v))
    lw = _chunk(log_decay.to(f32).expand(b, h, t, log_decay.shape[-1]), c)
    # made like q (under sharding, placed as it is)
    state = (initial_state.to(f32) if initial_state is not None
             else torch.zeros_like(qf[:, :, 0, :1].transpose(-1, -2)
                                   .expand(b, h, dk, dv)))
    # strict-lower mask (j < t) for the intra-chunk attention matrix
    tri = torch.tril(torch.ones(c, c, dtype=f32, device=q.device), -1)

    outs = []
    for i in range(t // c):
        qc, kc, vc, lwc = qf[:, :, i], kf[:, :, i], vf[:, :, i], lw[:, :, i]
        inc = torch.cumsum(lwc, dim=-2)                   # inclusive sum
        exc = inc - lwc                                   # exclusive sum
        tot = inc[..., -1:, :]                            # (B, H, 1, dk|1)
        q_dec = qc * torch.exp(exc if mode == "rwkv" else inc)
        k_dec = kc * torch.exp(-inc)                      # undo decay at j
        k_tail = kc * torch.exp(tot - inc)                # decay j -> end

        inter = torch.einsum("bhcd,bhde->bhce", q_dec, state)
        att = torch.einsum("bhcd,bhjd->bhcj", q_dec, k_dec) * tri
        intra = torch.einsum("bhcj,bhje->bhce", att, vc)
        if mode == "rwkv":
            diag = torch.sum(qc * bonus.to(f32)[None, :, None, :] * kc, -1,
                             keepdim=True)
        else:
            diag = torch.sum(qc * kc, -1, keepdim=True)
        outs.append(inter + intra + diag * vc)
        # decay the carried state through the chunk, add the rank-C update
        state = (state * torch.exp(tot).transpose(-1, -2)
                 + torch.einsum("bhjd,bhje->bhde", k_tail, vc))
    out = torch.stack(outs, dim=2).reshape(b, h, t, dv)
    return out.to(q.dtype), state


def linear_attention_step(
        state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor, log_decay: torch.Tensor, *,
        bonus: Optional[torch.Tensor] = None, mode: str = "rwkv"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent update. state: (B, H, dk, dv) f32; q, k:
    (B, H, dk); v: (B, H, dv); log_decay: (B, H, dk) or (B, H, 1).

    Returns ``(out (B, H, dv) in q.dtype, new_state)``."""
    f32 = torch.float32
    qf, kf, vf = (x.to(f32) for x in (q, k, v))
    w = torch.exp(log_decay.to(f32).expand_as(kf))
    outer = torch.einsum("bhd,bhe->bhde", kf, vf)
    if mode == "rwkv":
        out = (torch.einsum("bhd,bhde->bhe", qf, state)
               + torch.sum(qf * bonus.to(f32)[None] * kf, -1, keepdim=True)
               * vf)
        new_state = state * w[..., None] + outer
    else:
        new_state = state * w[..., None] + outer
        out = torch.einsum("bhd,bhde->bhe", qf, new_state)
    return out.to(q.dtype), new_state
