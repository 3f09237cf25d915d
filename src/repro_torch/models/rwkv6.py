"""RWKV-6 "Finch" blocks [arXiv:2404.05892]: time-mix and channel-mix.

Port of ``repro/models/rwkv6.py``: token-shift lerps, a data-dependent
per-channel decay through a low-rank adapter, the bonus ``u`` current-token
term, a per-head group norm and a squared-ReLU channel-mix. The decay keeps
the reference's parameterization, ``log w = -MAX_LOG_DECAY * sigmoid(w0 +
lora(x))``, so the per-step log-decay lies in (-1, 0): the chunked scan's
numerics contract (``models/linear_attn.py``).

Sequence mode (:func:`time_mix`) runs from a zero state, on the chunked
linear-attention kernel in ``rwkv`` mode on the serving route and on the
plain differentiable scan on the training routes (``ssm.linear_scan``);
the one-token step
(:func:`time_mix_step`) is plain tensor code, as the reference computes it
outside any kernel. The decay adapter, ``decay_base``, ``bonus`` and
``gn_scale`` stay f32 whatever the model's dtype, and the log-decay is
computed in f32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, group_norm_heads
from repro_torch.models.linear_attn import (MAX_LOG_DECAY,
                                            linear_attention_step)
from repro_torch.models.ssm import linear_scan

DECAY_LORA = 64
CHUNK = 64      # the reference's chunk_size; 64 * MAX_LOG_DECAY <= 80


def init_time_mix(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                  num_layers: int) -> dict:
    """The reference's time-mix parameters, stacked on a leading layer
    axis."""
    d, hd, L = cfg.d_model, cfg.num_heads * cfg.head_dim, num_layers
    h, dh, dev = cfg.num_heads, cfg.head_dim, gen.device

    def dense(shape, dt=dtype):
        return dense_init(gen, (L,) + shape, in_axis_size=shape[0], dtype=dt)

    f32 = torch.float32
    return {
        "mix": torch.full((L, 5, d), 0.5, dtype=dtype, device=dev),
        "w_r": dense((d, hd)), "w_k": dense((d, hd)), "w_v": dense((d, hd)),
        "w_g": dense((d, hd)), "w_o": dense((hd, d)),
        "decay_base": torch.zeros(L, h, dh, dtype=f32, device=dev),
        "decay_a": dense((d, DECAY_LORA), f32),
        "decay_b": dense((DECAY_LORA, hd), f32) * 0.1,
        "bonus": torch.zeros(L, h, dh, dtype=f32, device=dev),
        "gn_scale": torch.ones(L, h, dh, dtype=f32, device=dev),
    }


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, num_layers: int) -> dict:
    d, f, L = cfg.d_model, cfg.d_ff, num_layers

    def dense(shape):
        return dense_init(gen, (L,) + shape, in_axis_size=shape[0],
                          dtype=dtype)

    return {
        "mix": torch.full((L, 2, d), 0.5, dtype=dtype, device=gen.device),
        "w_k": dense((d, f)), "w_v": dense((f, d)), "w_r": dense((d, d)),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; y_0 = prev. x: (B, T, d), prev: (B, d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _log_decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    lora = torch.tanh(xw.float() @ p["decay_a"]) @ p["decay_b"]
    base = p["decay_base"].reshape(-1)
    return -MAX_LOG_DECAY * torch.sigmoid(base + lora)   # (..., H*dh), f32


def _heads(x: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """(B, T, H*dh) -> (B, H, T, dh)."""
    b, t = x.shape[:2]
    return x.reshape(b, t, h, dh).transpose(1, 2)


def time_mix(p: dict, x: torch.Tensor, prev: torch.Tensor, cfg: ModelConfig,
             *, attn_impl: str = "kernel"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequence-mode time-mix from a zero state. x: (B, T, d) ->
    ``(out (B, T, d), last_x (B, d), state (B, H, dh, dh) f32)``; the scan
    on the route ``attn_impl`` names."""
    b, t, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    xs = _shift(x, prev)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mix[i] * (xs - x) for i in range(5))
    r = _heads(xr @ p["w_r"], h, dh)
    k = _heads(xk @ p["w_k"], h, dh)
    v = _heads(xv @ p["w_v"], h, dh)
    g = xg @ p["w_g"]
    lw = _heads(_log_decay(p, xw), h, dh)
    out, state = linear_scan(r, k, v, lw, attn_impl=attn_impl, mode="rwkv",
                             chunk=CHUNK, bonus=p["bonus"])
    out = group_norm_heads(out.transpose(1, 2), p["gn_scale"])
    out = (out.reshape(b, t, h * dh) * F.silu(g)) @ p["w_o"]
    return out, x[:, -1], state


def time_mix_step(p: dict, x: torch.Tensor, prev: torch.Tensor,
                  state: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token time-mix. x: (B, d) -> ``(out (B, d), new_prev,
    new_state)``."""
    b = x.shape[0]
    h, dh = cfg.num_heads, cfg.head_dim
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mix[i] * (prev - x) for i in range(5))
    r = (xr @ p["w_r"]).reshape(b, h, dh)
    k = (xk @ p["w_k"]).reshape(b, h, dh)
    v = (xv @ p["w_v"]).reshape(b, h, dh)
    g = xg @ p["w_g"]
    lw = _log_decay(p, xw).reshape(b, h, dh)
    out, state = linear_attention_step(state, r, k, v, lw, bonus=p["bonus"],
                                       mode="rwkv")
    out = group_norm_heads(out, p["gn_scale"]).reshape(b, h * dh)
    out = (out * F.silu(g)) @ p["w_o"]
    return out, x, state


def _channel(p: dict, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    mix = p["mix"].to(x.dtype)
    xk = x + mix[0] * (xs - x)
    xr = x + mix[1] * (xs - x)
    kk = F.relu(xk @ p["w_k"]).square()
    return torch.sigmoid(xr @ p["w_r"]) * (kk @ p["w_v"])


def channel_mix(p: dict, x: torch.Tensor, prev: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-mode channel-mix (squared-ReLU gated MLP with token
    shift). x: (B, T, d) -> ``(out, last_x (B, d))``."""
    return _channel(p, x, _shift(x, prev)), x[:, -1]


def channel_mix_step(p: dict, x: torch.Tensor, prev: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token channel-mix. x: (B, d) -> ``(out, new_prev)``."""
    return _channel(p, x, prev), x
