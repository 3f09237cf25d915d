"""Prefill flash attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/flash_prefill`` (``flash_prefill`` and its wrapper
``flash_attention``), extended with per-row query offsets: row b's queries
sit at absolute positions ``q_start[b] .. q_start[b] + Sq - 1`` and attend
keys ``[0, kv_len[b])`` under the causal (and optional sliding-window) mask.
First prefill chunks pass ``q_start = 0`` over their own K/V, which is the
reference kernel's function; continuation chunks pass their offset over a
lane gathered from the pool. The kernel lives in
``kernels/csrc/flash_prefill.cu``; its source note says what bounds it. In
bf16 it runs both products on the tensor cores (wgmma), in f32 on CUDA
cores.

Contract: every query row must see at least one key (true whenever
``q_start >= 0`` and ``kv_len >= 1``, causal or not, without a window). A
row with none is outside the contract, and the kernel and the plain version
differ there. The plain version gives it the uniform average of all of V.
The kernel gives it zeros when its 64-row query tile walks no key tile
(``kv_len == 0``, or a window past every key), and otherwise the average of
V over the key tiles that query tile walks (32 rows each in bf16, 64 in
f32), rows past ``Skv`` counting as zeros.

On a CPU or ``meta`` tensor (a shape-only trace) the wrapper computes the
plain version; on a CUDA tensor it launches the kernel or raises, as on any
other device. ``flash_attention.launches`` counts kernel
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
# (QK, V) widths of the compiled instance whose values are narrower than its
# queries and keys: MLA's non-absorbed prefill, bf16 only
MLA_DIMS = ((192, 128),)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_start: torch.Tensor, kv_len: torch.Tensor, *,
                          causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, dh); k: (B, KH, Skv, dh); v: (B, KH, Skv, dv); q_start,
    kv_len: (B,) int -> (B, H, Sq, dv). f32 math, as the reference's
    ``flash_prefill_ref``; the scale is ``scale``, or ``dh ** -0.5``."""
    b, h, sq, dh = q.shape
    kh, skv = k.shape[1], k.shape[2]
    kk = k.float().repeat_interleave(h // kh, dim=1)
    vv = v.float().repeat_interleave(h // kh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (
        dh ** -0.5 if scale is None else scale)
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
    lib.flash_prefill_mla.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                      i, i, ctypes.c_float, p]
    lib.flash_prefill_mla.restype = i
    lib.flash_prefill_tile_check.argtypes = [p, p, p, p, p, i, p]
    lib.flash_prefill_tile_check.restype = i
    return lib


def wgmma_tile_check_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor):
    """q, k, v: (64, dh) bf16 -> (s, o) in f32: ``s = q k^T`` and
    ``o = bf16(s) v``, the two products of the bf16 kernel on one tile."""
    s = q.float() @ k.float().T
    return s, s.to(torch.bfloat16).float() @ v.float()


def wgmma_tile_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The bf16 kernel's two tensor-core products on one 64-row query tile
    and 64 keys (walked in the kernel's key tiles), through the same
    swizzled shared-memory tiles and wgmma descriptors: a check of that
    layout against plain matrix products. Not on any served path. Same
    arguments and results as the plain version."""
    if q.is_cpu:
        return wgmma_tile_check_plain(q, k, v)
    what = "wgmma_tile_check"
    build.require_cuda_operands(what, q, k, v)
    if (q.shape != k.shape or q.shape != v.shape or q.shape[0] != 64
            or q.shape[1] not in HEAD_DIMS or q.dtype != torch.bfloat16
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"{what}: q, k, v must be (64, dh) bf16 with dh "
                         f"one of {HEAD_DIMS}")
    s = torch.empty(64, 64, dtype=torch.float32, device=q.device)
    o = torch.empty(64, q.shape[1], dtype=torch.float32, device=q.device)
    lib = _lib()
    code = lib.flash_prefill_tile_check(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(),
        q.shape[1], build.current_stream(q.device))
    build.check_launch(lib, code, what)
    return s, o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_start: torch.Tensor, kv_len: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, dh); k: (B, KH, Skv, dh); v: (B, KH, Skv, dv); q_start,
    kv_len: (B,) int32 -> (B, H, Sq, dv). KV head of query head h is
    ``h // (H // KH)``; the scale is ``scale``, or ``dh ** -0.5``. ``dv``
    is ``dh``, or a
    pair of ``MLA_DIMS`` in bf16. Refuses operands that require grad (no
    backward)."""
    build.refuse_grad("flash_attention", q, k, v)
    if build.plain_device(q):
        return flash_attention_plain(q, k, v, q_start, kv_len, causal=causal,
                                     window=window, scale=scale)
    what = "flash_attention"
    build.require_cuda_operands(what, q, k, v, q_start, kv_len)
    b, h, sq, dh = q.shape
    dv = v.shape[-1]
    if (k.ndim != 4 or k.shape[0] != b or k.shape[3] != dh
            or v.shape[:3] != k.shape[:3] or h % k.shape[1]
            or q_start.shape != (b,) or kv_len.shape != (b,)):
        raise ValueError(f"{what}: inconsistent shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k and v must share one dtype of "
                         f"{list(build.DTYPE_CODES)}")
    if q_start.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError(f"{what}: q_start and kv_len must be int32")
    if dv != dh and ((dh, dv) not in MLA_DIMS or q.dtype != torch.bfloat16):
        raise ValueError(f"{what}: value width {dv} != head_dim {dh} is "
                         f"compiled for {MLA_DIMS} in bfloat16 only")
    if dv == dh and dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim must be one of {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be positive")
    build.require_aligned(what, q, k, v)
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty(b, h, sq, dv, dtype=q.dtype, device=q.device)
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_start.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), b, h, k.shape[1], sq,
            k.shape[2])
    if dv == dh:
        code = lib.flash_prefill(
            build.DTYPE_CODES[q.dtype], *args, dh, int(causal), window or 0,
            scale, build.current_stream(q.device))
    else:
        code = lib.flash_prefill_mla(
            *args, dh, dv, int(causal), window or 0, scale,
            build.current_stream(q.device))
    build.check_launch(lib, code, what)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
