"""Prefill flash attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/flash_prefill`` (``flash_prefill`` and its wrapper
``flash_attention``), extended with per-row query offsets: row b's queries
sit at absolute positions ``q_start[b] .. q_start[b] + Sq - 1`` and attend
keys ``[0, kv_len[b])`` under the causal (and optional sliding-window) mask.
First prefill chunks pass ``q_start = 0`` over their own K/V, which is the
reference kernel's function; continuation chunks pass their offset over a
lane gathered from the pool. The kernel lives in
``kernels/csrc/flash_prefill.cu``; its source note says what bounds it.

Contract: every query row must see at least one key (true whenever
``q_start >= 0`` and ``kv_len >= 1``, causal or not, without a window). A
row with none is outside the contract: the kernel writes zeros there, the
plain version a uniform average.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. ``flash_attention.launches`` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)   # the kernel's compiled head_dim instances


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_start: torch.Tensor, kv_len: torch.Tensor, *,
                          causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, dh); k/v: (B, KH, Skv, dh); q_start, kv_len: (B,) int
    -> (B, H, Sq, dh). f32 math, as the reference's ``flash_prefill_ref``."""
    b, h, sq, dh = q.shape
    kh, skv = k.shape[1], k.shape[2]
    kk = k.float().repeat_interleave(h // kh, dim=1)
    vv = v.float().repeat_interleave(h // kh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * dh ** -0.5
    qpos = (q_start.to(q.device).long()[:, None]
            + torch.arange(sq, device=q.device)[None, :])       # (B, Sq)
    kpos = torch.arange(skv, device=q.device)[None, None, :]    # (1, 1, Skv)
    mask = kpos < kv_len.to(q.device).long()[:, None, None]     # (B, 1, Skv)
    if causal:
        mask = mask & (kpos <= qpos[:, :, None])
    if window is not None:
        mask = mask & (qpos[:, :, None] - kpos < window)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_prefill")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_prefill.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                  ctypes.c_float, p]
    lib.flash_prefill.restype = i
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_start: torch.Tensor, kv_len: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, dh); k/v: (B, KH, Skv, dh); q_start, kv_len: (B,) int32
    -> (B, H, Sq, dh). KV head of query head h is ``h // (H // KH)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_start, kv_len, causal=causal,
                                     window=window)
    what = "flash_attention"
    build.require_cuda_operands(what, q, k, v, q_start, kv_len)
    b, h, sq, dh = q.shape
    if (k.ndim != 4 or k.shape[0] != b or k.shape[3] != dh
            or v.shape != k.shape or h % k.shape[1]
            or q_start.shape != (b,) or kv_len.shape != (b,)):
        raise ValueError(f"{what}: inconsistent shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k and v must share one dtype of "
                         f"{list(build.DTYPE_CODES)}")
    if q_start.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError(f"{what}: q_start and kv_len must be int32")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim must be one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be positive")
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.flash_prefill(
        build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_start.data_ptr(), kv_len.data_ptr(), out.data_ptr(), b, h,
        k.shape[1], sq, k.shape[2], dh, int(causal), window or 0, dh ** -0.5,
        build.current_stream(q.device))
    build.check_launch(lib, code, what)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
