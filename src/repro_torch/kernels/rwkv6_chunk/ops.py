"""Chunked linear attention: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/rwkv6_chunk`` (``rwkv6_chunk`` and its wrapper
``linear_attention_pallas``), in both modes: ``rwkv`` (vector decay plus
the bonus ``u``) and ``ssd`` (scalar decay, diagonal ``q.k``). Unlike the
Pallas kernel, which left the state to the XLA path, the kernel also writes
the final f32 state, which the serving engine keeps as the SSM decode state.
The kernel lives in ``kernels/csrc/rwkv6_chunk.cu``; its source note says
what bounds it and how.

The plain version is the port's ``models.linear_attn
.chunked_linear_attention``. On a CPU tensor the wrapper computes it; on a
CUDA tensor it launches the kernel or raises. ``linear_attention.launches``
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.models.linear_attn import (MAX_LOG_DECAY,
                                            chunked_linear_attention)

CHUNKS = (32, 64)   # the kernel's compiled chunk lengths
MAX_DIM = 64        # dk and dv
KERNEL_DKS = (16, 32, 64)   # the kernel's compiled dk
DV_STEP = 8                 # dv is a multiple of this (mma tiles)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv6_chunk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_attn_chunk.argtypes = [i, i, i, p, p, p, p, i, p, p, p, i, i,
                                      i, i, i, p]
    lib.linear_attn_chunk.restype = i
    lib.linear_attn_tile_check.argtypes = [p] * 7
    lib.linear_attn_tile_check.restype = i
    lib.linear_attn_occupancy.argtypes = [i] * 5 + [p, p]
    lib.linear_attn_occupancy.restype = i
    return lib


def kernel_occupancy(dtype: torch.dtype, chunk: int, dk: int, dv: int,
                     lw_dim: int) -> Tuple[int, int]:
    """(dynamic shared memory in bytes, blocks per SM) of the kernel at
    these dimensions, from the CUDA occupancy calculator (card only)."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    lib = _lib()
    code = lib.linear_attn_occupancy(build.DTYPE_CODES[dtype], chunk, dk, dv,
                                     lw_dim, ctypes.byref(smem),
                                     ctypes.byref(blocks))
    build.check_launch(lib, code, "kernel_occupancy")
    return smem.value, blocks.value


def tf32_tile_check_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """a, b, c: (64, 64) f32 -> (s, o, u): ``s = a b^T``, ``o = s c`` and
    ``u = a^T c``, the kernel's three kinds of chunk product on one tile."""
    s = a @ b.T
    return s, s @ c, a.T @ c


def tf32_tile_check(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The kernel's 3xTF32 tensor-core products and fragment layouts on one
    bare tile (Q_dec K_dec^T, att V from the score accumulators, and
    K_tail^T V): a check of them against plain f32 matrix products. Not on
    any served path. Same arguments and results as the plain version, except
    that ``o`` multiplies the kernel's own ``s``."""
    if a.is_cpu:
        return tf32_tile_check_plain(a, b, c)
    what = "tf32_tile_check"
    build.require_cuda_operands(what, a, b, c)
    if any(x.shape != (64, 64) or x.dtype != torch.float32
           for x in (a, b, c)):
        raise ValueError(f"{what}: a, b, c must be (64, 64) f32")
    s, o, u = (torch.empty(64, 64, device=a.device) for _ in range(3))
    lib = _lib()
    code = lib.linear_attn_tile_check(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), s.data_ptr(), o.data_ptr(),
        u.data_ptr(), build.current_stream(a.device))
    build.check_launch(lib, code, what)
    return s, o, u


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_decay: torch.Tensor,
                     bonus: Optional[torch.Tensor] = None, *,
                     mode: str = "rwkv", chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, H, T, dk); v: (B, H, T, dv); log_decay: (B, H, T, dk)
    (``rwkv``) or (B, H, T, 1) (``ssd``); bonus: (H, dk), ``rwkv`` only.

    Returns ``(out (B, H, T, dv) in q.dtype, final_state (B, H, dk, dv)
    f32)``, from a zero initial state. T is padded to a multiple of
    ``chunk`` with zero k, v and log-decay, which leaves the state as it
    was. ``chunk`` is at most 64: the log-decay contract
    (``chunk * MAX_LOG_DECAY <= 80`` keeps ``exp`` of the in-chunk sums in
    f32 range) and the kernel's shared-memory tiles both bound it. On the
    card dk is 16, 32 or 64 and dv a multiple of 8 up to 64. Refuses
    operands that require grad (no backward)."""
    what = "linear_attention"
    build.refuse_grad(what, q, k, v, log_decay, bonus)
    if mode not in ("rwkv", "ssd"):
        raise ValueError(f"{what}: mode must be 'rwkv' or 'ssd'")
    if chunk not in CHUNKS:
        raise ValueError(
            f"{what}: chunk={chunk} is not one of {CHUNKS}; chunks above 64 "
            f"break the decay contract chunk * MAX_LOG_DECAY "
            f"({MAX_LOG_DECAY:g}) <= 80 (exp of the in-chunk log-decay sum "
            f"overflows f32)")
    if (mode == "rwkv") != (bonus is not None):
        raise ValueError(f"{what}: bonus is required in rwkv mode and "
                         f"unused in ssd mode")
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    lw_dim = log_decay.shape[-1]
    if (k.shape != q.shape or v.shape[:3] != (b, h, t)
            or log_decay.shape[:3] != (b, h, t)
            or lw_dim != (dk if mode == "rwkv" else 1)):
        raise ValueError(f"{what}: inconsistent shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} "
                         f"log_decay={tuple(log_decay.shape)} ({mode})")
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        log_decay = F.pad(log_decay, (0, 0, 0, pad))
    if q.device.type == "cpu":
        out, state = chunked_linear_attention(q, k, v, log_decay, bonus=bonus,
                                              mode=mode, chunk_size=chunk)
        return out[:, :, :t], state

    lw = log_decay.to(torch.float32).contiguous()
    u = bonus.to(torch.float32).contiguous() if bonus is not None else None
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    build.require_cuda_operands(what, q, k, v, lw, *(() if u is None
                                                     else (u,)))
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k and v must share one dtype of "
                         f"{list(build.DTYPE_CODES)}")
    if dk not in KERNEL_DKS or dv > MAX_DIM or dv % DV_STEP:
        raise ValueError(f"{what}: dk must be one of {KERNEL_DKS} and dv a "
                         f"multiple of {DV_STEP} up to {MAX_DIM}")
    build.require_aligned(what, q, k, v, lw)
    if u is not None and u.shape != (h, dk):
        raise ValueError(f"{what}: bonus must be (H, dk)")
    tp = t + pad
    out = torch.empty(b, h, tp, dv, dtype=q.dtype, device=q.device)
    state = torch.empty(b, h, dk, dv, dtype=torch.float32, device=q.device)
    lib = _lib()
    code = lib.linear_attn_chunk(
        build.DTYPE_CODES[q.dtype], int(mode == "rwkv"), chunk, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), lw.data_ptr(), lw_dim,
        u.data_ptr() if u is not None else None, out.data_ptr(),
        state.data_ptr(), b, h, tp, dk, dv, build.current_stream(q.device))
    build.check_launch(lib, code, what)
    linear_attention.launches += 1
    return out[:, :, :t], state


linear_attention.launches = 0
