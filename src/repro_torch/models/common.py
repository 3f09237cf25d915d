"""Shared building blocks: norms, initializers, activations, positional codes.

Port of ``repro/models/common.py``. Reductions (norm statistics, rope
rotation) run in float32 regardless of the parameter dtype. Initializers draw
from an explicit ``torch.Generator``; they follow the reference's
distributions, not its random bits (parity tests bridge JAX parameters).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ACT_GELU, ACT_SILU, ACT_SQ_RELU


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
class ShapeOnly:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which has
    none: the initializers given it make shape-only tensors and draw
    nothing."""
    device = torch.device("meta")


def generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``, or
    :class:`ShapeOnly` for ``meta``."""
    if device.type == "meta":
        return ShapeOnly()
    return torch.Generator(device=device).manual_seed(seed)


def randn(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal f32 draws on ``gen``'s device (shape only on
    ``meta``)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(tuple(shape), device="meta")
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               in_axis_size: Optional[int] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, drawn in f32 on ``gen``'s device
    (shape only on ``meta``)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)    # in place: one f32 copy of a leaf


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return randn(gen, shape).mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(d_model: int, kind: str, dtype: torch.dtype,
              device: torch.device) -> dict:
    p = {"scale": torch.ones(d_model, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d_model, dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm (RWKV output norm). x: (..., H, dh)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def activate(h: torch.Tensor, gate: Optional[torch.Tensor],
             kind: str) -> torch.Tensor:
    if kind == ACT_SILU:
        if gate is None:
            raise ValueError("SwiGLU requires a gate projection")
        return F.silu(gate) * h
    if kind == ACT_SQ_RELU:
        return F.relu(h).square()
    if kind == ACT_GELU:
        return F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(f"unknown activation {kind!r}")


def gated(kind: str) -> bool:
    return kind == ACT_SILU


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate the two halves. x: (B, S, H, dh); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (half,)
    ang = positions[..., None].float() * freqs                 # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]                        # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def mrope_sections(head_dim: int) -> tuple:
    """Split of the ``head_dim // 2`` frequency pairs into (t, h, w)
    sections: (1/4, 3/8, 3/8), as the reference generalises Qwen2-VL's
    [16, 24, 24] of 64 pairs."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Multimodal RoPE. x: (B, S, H, dh); positions_thw: (3, B, S) int,
    the temporal, height and width ids. Each section of frequency pairs
    rotates by its own position stream [arXiv:2409.12191 §2.1]; with the
    three streams equal it is :func:`apply_rope`."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (half,)
    pos = torch.cat([p[..., None].expand(*p.shape, n) for p, n in
                     zip(positions_thw, mrope_sections(x.shape[-1]))],
                    -1).float()                                # (B, S, half)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def positions_for(batch: int, start, seq: int,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Linear positions (B, S) int32 starting at ``start`` (int or (B,))."""
    base = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    start = torch.as_tensor(start, dtype=torch.int32, device=device)
    if start.ndim == 0:
        start = start[None]
    return (base + start[:, None]).expand(batch, seq)
