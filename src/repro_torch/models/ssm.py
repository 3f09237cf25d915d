"""Mamba-2 / SSD selective-state-space block (the Hymba SSM heads).

Port of ``repro/models/ssm.py``::

    h_t = exp(-exp(A_log) * dt_t) * h_{t-1} + dt_t B_t x_t
    y_t = C_t h_t ,   y = y * silu(z) @ W_out

Sequence mode (:func:`apply_ssm`) runs the chunked linear-attention kernel
in ``ssd`` mode (scalar per-head decay) on the serving route
(``attn_impl="kernel"``), and the plain, differentiable chunked scan
(``models/linear_attn.py``) on the training routes (``"naive"``,
``"chunked"``), as the kernel has no backward; the one-token step
(:func:`ssm_step`) is plain tensor code, as the reference has no kernel for
it. B/C are shared across heads (as in Mamba-2). A depthwise causal conv
keeps a ``conv_width - 1`` tail as decode state. The log-decay is clamped to
the scan's numerics contract.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_chunk.ops import linear_attention
from repro_torch.models.common import dense_init
from repro_torch.models.linear_attn import (MAX_LOG_DECAY,
                                            chunked_linear_attention,
                                            linear_attention_step)

# Largest chunk of the SSD scan. The scan needs chunk * MAX_LOG_DECAY <= 80
# (models/linear_attn.py): past that, exp of the in-chunk log-decay sum
# overflows f32. hymba_1_5b publishes chunk_size=128, and at init
# (a_log = dt_bias = 0, so dt ~ softplus(0) = 0.69) a 128-row chunk sums to
# about -88: the reference's own prefill then yields NaN for prompts of 128
# tokens or more. The chunk is only a tiling of the same recurrence, so
# running it at 64 changes no result the model defines.
MAX_SSD_CHUNK = 64


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.state_size


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             num_layers: int) -> dict:
    """The reference's SSM parameters, stacked on a leading layer axis;
    ``dt_bias`` and ``a_log`` stay f32 whatever ``dtype`` is."""
    d, s, L = cfg.d_model, cfg.ssm, num_layers
    d_inner, nh, n = _dims(cfg)
    dev = gen.device

    def dense(shape, fan_in=None):
        return dense_init(gen, (L,) + shape, in_axis_size=fan_in or shape[0],
                          dtype=dtype)

    conv = torch.randn(L, s.conv_width, d_inner, generator=gen,
                       dtype=torch.float32, device=dev) * (1.0 / s.conv_width)
    return {
        "w_in": dense((d, 2 * d_inner)),                     # x | z
        "conv": conv.to(dtype),
        "w_bc": dense((d_inner, 2 * n)),                     # B | C
        "w_dt": dense((d_inner, nh)),
        "dt_bias": torch.zeros(L, nh, dtype=torch.float32, device=dev),
        "a_log": torch.zeros(L, nh, dtype=torch.float32, device=dev),
        "w_out": dense((d_inner, d)),
    }


def _conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv. x: (B, T, Di), w: (K, Di), tail: (B, K-1, Di)."""
    k, t = w.shape[0], x.shape[1]
    xp = torch.cat([tail, x], dim=1)                         # (B, T+K-1, Di)
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return F.silu(out), xp[:, -(k - 1):]


def _gates(p: dict, xc: torch.Tensor, n: int):
    """Post-conv projections. xc: (B, T, Di) -> (B, C per step, dt f32,
    log-decay f32)."""
    bc = xc @ p["w_bc"]
    b_in, c_out = bc[..., :n], bc[..., n:]                   # (B, T, N) each
    pre = (xc @ p["w_dt"]).float() + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))         # softplus
    log_decay = torch.clamp(-torch.exp(p["a_log"]) * dt, -MAX_LOG_DECAY,
                            -1e-6)
    return b_in, c_out, dt, log_decay


def linear_scan(q, k, v, log_decay, *, attn_impl: str, mode: str,
                chunk: int, bonus=None):
    """The chunked linear-attention scan of a sequence-mode block: the
    kernel's wrapper on the serving route (``attn_impl="kernel"``), the
    plain differentiable scan on the training routes (``"naive"``,
    ``"chunked"``). The route is the caller's choice, never the device's."""
    if attn_impl == "kernel":
        return linear_attention(q, k, v, log_decay, bonus, mode=mode,
                                chunk=chunk)
    if attn_impl not in ("naive", "chunked"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    return chunked_linear_attention(q, k, v, log_decay, bonus=bonus,
                                    mode=mode, chunk_size=chunk)


def apply_ssm(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              attn_impl: str = "kernel"):
    """Sequence mode from a zero state. x: (B, T, d) -> (y (B, T, d),
    conv_tail (B, K-1, Di), state (B, nh, N, head_dim) f32). The scan runs
    on the route ``attn_impl`` names (:func:`linear_scan`)."""
    b, t, _ = x.shape
    s = cfg.ssm
    d_inner, nh, n = _dims(cfg)
    xz = x @ p["w_in"]
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    tail = torch.zeros(b, s.conv_width - 1, d_inner, dtype=x.dtype,
                       device=x.device)
    xc, conv_tail = _conv(xi, p["conv"], tail)
    b_in, c_out, dt, log_decay = _gates(p, xc, n)
    # fold dt into v (rounded to the model dtype first, as the reference);
    # B and C are shared by every head
    v = (xc.reshape(b, t, nh, s.head_dim)
         * dt[..., None].to(x.dtype)).transpose(1, 2)         # (B, nh, T, hd)
    q = c_out[:, None].expand(b, nh, t, n)
    kk = b_in[:, None].expand(b, nh, t, n)
    lw = log_decay.transpose(1, 2)[..., None]                 # (B, nh, T, 1)
    y, state = linear_scan(q, kk, v, lw, attn_impl=attn_impl, mode="ssd",
                           chunk=min(s.chunk_size, MAX_SSD_CHUNK))
    y = y.transpose(1, 2).reshape(b, t, d_inner)
    return (y * F.silu(z)) @ p["w_out"], conv_tail, state


def ssm_step(p: dict, x: torch.Tensor, cfg: ModelConfig,
             conv_tail: torch.Tensor, state: torch.Tensor):
    """One-token recurrent mode. x: (B, d) -> (y (B, d), conv_tail,
    state)."""
    b = x.shape[0]
    s = cfg.ssm
    d_inner, nh, n = _dims(cfg)
    xz = x @ p["w_in"]
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    window = torch.cat([conv_tail, xi[:, None]], dim=1)       # (B, K, Di)
    xc = F.silu(torch.einsum("bkd,kd->bd", window, p["conv"]))
    b_in, c_out, dt, log_decay = _gates(p, xc[:, None], n)
    v = xc.reshape(b, nh, s.head_dim) * dt[:, 0, :, None].to(x.dtype)
    q = c_out[:, 0, None].expand(b, nh, n)
    kk = b_in[:, 0, None].expand(b, nh, n)
    y, state = linear_attention_step(state, q, kk, v,
                                     log_decay[:, 0, :, None], mode="ssd")
    y = y.reshape(b, d_inner)
    return (y * F.silu(z)) @ p["w_out"], window[:, 1:], state
