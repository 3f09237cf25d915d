"""Decode attention: the CUDA kernels' wrappers and their plain versions.

Port of ``repro/kernels/flash_decode``:

* :func:`paged_decode_attention` replaces ``flash_decode_paged`` (wrapper
  ``paged_decode_attention_pallas``); kernel ``kernels/csrc/
  flash_decode_paged.cu``. Pools are one layer of the engine's ``(L, N+1,
  bs, KH, dh)`` pool, i.e. ``(N+1, bs, KH, dh)``: block-major with the KV
  heads inside each row, so the kernel reads a table entry's rows without
  any lane gather. It is split-KV: one call launches two device kernels
  (the splits, then their fixed-order merge), or one when the whole table
  fits a single split.
* :func:`latent_decode_attention` replaces no TPU kernel (the JAX package
  has no latent attention): MLA's absorbed decode over one layer of the
  engine's ``(L, N+1, bs, KD)`` latent pool, every row read once for all
  heads, K the whole row and V its first ``v_dim`` columns, both products
  on the tensor cores (bf16); kernel ``kernels/csrc/flash_decode_latent.cu``,
  split-KV over whole table entries like paged decode.
* :func:`ring_decode_attention` replaces ``flash_decode`` (wrapper
  ``decode_attention_pallas``); kernel ``kernels/csrc/flash_decode.cu``.
  Lanes are one layer of the engine's heads-first ``(L, S, KH, W, dh)``
  lanes, addressed by slot, so decode reads each sequence's lane in place;
  the ring and window mask is computed in the kernel from per-row ``pos``
  instead of arriving as a (B, W) bias. It is split-KV over fixed runs of
  lane rows, like paged decode: two device kernels a call, or one when the
  lane fits a single split.

Each source note says what bounds its kernel and how. On a CPU or ``meta``
tensor (a shape-only trace: no values, so no kernel to stand in for) a
wrapper computes its plain version; on a CUDA tensor it launches its kernel
or raises, as on any other device. ``<wrapper>.launches`` counts kernel launches, and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.models.attention import decode_attention

NEG_INF = -1e30
MAX_GROUP = 8         # query heads per KV head (kernel register tile)
PAGED_HEAD_DIMS = (32, 64, 128, 256)   # the paged kernel's compiled head_dims
SPLIT_ROWS = 64       # rows per split of the paged kernel (whole entries)
RING_HEAD_DIMS = (32, 64, 128)   # the ring kernel's compiled head_dims
RING_SPLIT_ROWS = 64  # lane rows per split of the ring kernel


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, dh); pools: (N, bs, KH, dh); block_tables: (B, max_blocks)
    int; lengths: (B,) int -> (B, H, dh). f32 math, as the reference's
    ``flash_decode_paged_ref``: gather each table into a lane, mask rows at
    positions >= lengths[b] with NEG_INF, softmax, weight V."""
    b, h, dh = q.shape
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    w = block_tables.shape[1] * bs
    tables = block_tables.long()
    k = k_pool[tables].reshape(b, w, kh, dh).float()           # (B, W, KH, dh)
    v = v_pool[tables].reshape(b, w, kh, dh).float()
    qg = q.reshape(b, kh, h // kh, dh).float()
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k) * dh ** -0.5
    pos = torch.arange(w, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]  # (B, W)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v)
    return out.reshape(b, h, dh).to(q.dtype)


def split_geometry(block_size: int, max_blocks: int) -> Tuple[int, int]:
    """(table entries per split, splits per sequence) of the paged kernel.
    A split is ``SPLIT_ROWS`` rows of whole entries (at least one), a
    function of the block size alone, so a row's result never depends on
    the rest of the batch."""
    entries = max(1, SPLIT_ROWS // block_size)
    return entries, -(-max_blocks // entries)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_decode_paged")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i,
                                 i, ctypes.c_float, p]
    lib.paged_decode.restype = i
    return lib


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, dh); pools: (N, bs, KH, dh); block_tables: (B, max_blocks)
    int32; lengths: (B,) int32 -> (B, H, dh).

    Every table entry must name a block of the pool (padding entries may
    point at a shared null block: rows past ``lengths[b]`` are masked). A
    sequence with ``lengths[b] == 0`` gets the uniform average of its table's
    rows, as the reference does. On the card the call launches the split
    kernel and, when a table spans more than one split, the merge kernel;
    ``launches`` counts calls. Refuses operands that require grad (no
    backward)."""
    build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    if build.plain_device(q):
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths)
    what = "paged_decode_attention"
    build.require_cuda_operands(what, q, k_pool, v_pool, block_tables,
                                lengths)
    b, h, dh = q.shape
    n, bs, kh, pdh = k_pool.shape
    if (v_pool.shape != k_pool.shape or pdh != dh or h % kh
            or block_tables.ndim != 2 or block_tables.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(f"{what}: inconsistent shapes q={tuple(q.shape)} "
                         f"pool={tuple(k_pool.shape)} "
                         f"tables={tuple(block_tables.shape)} "
                         f"lengths={tuple(lengths.shape)}")
    if q.dtype not in build.DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"{what}: q and pools must share one dtype of "
                         f"{list(build.DTYPE_CODES)}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: block_tables and lengths must be int32")
    if h // kh > MAX_GROUP or dh not in PAGED_HEAD_DIMS:
        raise ValueError(f"{what}: at most {MAX_GROUP} query heads per KV "
                         f"head and head_dim one of {PAGED_HEAD_DIMS}")
    build.require_aligned(what, q, k_pool, v_pool)
    out = torch.empty_like(q)
    max_blocks = block_tables.shape[1]
    entries, splits = split_geometry(bs, max_blocks)
    scratch = (torch.empty(b * h * splits * (dh + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    lib = _lib()
    code = lib.paged_decode(
        build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), b,
        kh, h // kh, dh, bs, max_blocks, entries, dh ** -0.5,
        build.current_stream(q.device))
    build.check_launch(lib, code, what)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Latent (MLA) pools
# ---------------------------------------------------------------------------
# (heads, k_dim, v_dim) the latent kernel compiles: MLA at kv_lora_rank 512,
# rope dim 64, 16 heads (Moonlight) or 64 (Kimi K2)
LATENT_SHAPES = ((16, 576, 512), (64, 576, 512))


def latent_decode_attention_plain(q: torch.Tensor, pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  lengths: torch.Tensor, v_dim: int,
                                  scale: float) -> torch.Tensor:
    """q: (B, H, KD); pool: (N, bs, KD); block_tables: (B, max_blocks) int;
    lengths: (B,) int -> (B, H, v_dim). f32 math: gather each table into a
    lane of latent rows, scores ``scale * q . row``, rows at positions >=
    lengths[b] masked with NEG_INF, softmax, weight the rows' first
    ``v_dim`` columns."""
    b, h, kd = q.shape
    bs = pool.shape[1]
    w = block_tables.shape[1] * bs
    lane = pool[block_tables.long()].reshape(b, w, kd).float()
    s = torch.einsum("bhk,bwk->bhw", q.float(), lane) * scale
    pos = torch.arange(w, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]   # (B, W)
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhw,bwv->bhv", p, lane[..., :v_dim]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _latent_lib() -> ctypes.CDLL:
    lib = build.load("flash_decode_latent")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.latent_decode.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                  ctypes.c_float, p]
    lib.latent_decode.restype = i
    return lib


def latent_decode_attention(q: torch.Tensor, pool: torch.Tensor,
                            block_tables: torch.Tensor,
                            lengths: torch.Tensor, v_dim: int,
                            scale: float) -> torch.Tensor:
    """q: (B, H, KD) absorbed queries; pool: (N, bs, KD) latent rows;
    block_tables: (B, max_blocks) int32; lengths: (B,) int32 -> (B, H,
    v_dim), the attention-weighted first ``v_dim`` columns of the rows.

    Table entries and lengths as :func:`paged_decode_attention`'s. On the
    card the call launches the split kernel and, when a table spans more
    than one split, the merge kernel, on PyTorch's current stream, with no
    host synchronisation (a CUDA graph captures it); ``launches`` counts
    calls. Refuses operands that require grad (no backward)."""
    build.refuse_grad("latent_decode_attention", q, pool)
    if build.plain_device(q):
        return latent_decode_attention_plain(q, pool, block_tables, lengths,
                                             v_dim, scale)
    what = "latent_decode_attention"
    build.require_cuda_operands(what, q, pool, block_tables, lengths)
    b, h, kd = q.shape
    if (pool.ndim != 3 or pool.shape[2] != kd or block_tables.ndim != 2
            or block_tables.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(f"{what}: inconsistent shapes q={tuple(q.shape)} "
                         f"pool={tuple(pool.shape)} "
                         f"tables={tuple(block_tables.shape)} "
                         f"lengths={tuple(lengths.shape)}")
    if (h, kd, v_dim) not in LATENT_SHAPES:
        raise ValueError(f"{what}: (heads, k_dim, v_dim) must be one of "
                         f"{LATENT_SHAPES}, got {(h, kd, v_dim)}")
    if q.dtype != torch.bfloat16 or pool.dtype != q.dtype:
        raise ValueError(f"{what}: q and pool must be bfloat16 (the "
                         f"kernel's tensor-core products)")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"{what}: block_tables and lengths must be int32")
    build.require_aligned(what, q, pool)
    bs = pool.shape[1]
    out = torch.empty(b, h, v_dim, dtype=q.dtype, device=q.device)
    max_blocks = block_tables.shape[1]
    entries, splits = split_geometry(bs, max_blocks)
    scratch = (torch.empty(b * h * splits * (v_dim + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    lib = _latent_lib()
    code = lib.latent_decode(
        build.DTYPE_CODES[q.dtype], q.data_ptr(), pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, h, kd, v_dim, bs,
        max_blocks, entries, scale, build.current_stream(q.device))
    build.check_launch(lib, code, what)
    latent_decode_attention.launches += 1
    return out


latent_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Contiguous / ring lanes
# ---------------------------------------------------------------------------
def ring_decode_attention_plain(q: torch.Tensor, k_lanes: torch.Tensor,
                                v_lanes: torch.Tensor, slots: torch.Tensor,
                                pos: torch.Tensor, *,
                                window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, dh); lanes: (S, KH, W, dh); slots, pos: (B,) int ->
    (B, H, dh): the port's ``decode_attention`` over each row's lane."""
    idx = slots.long()
    return decode_attention(q, k_lanes[idx].transpose(1, 2),
                            v_lanes[idx].transpose(1, 2), pos, window=window)


def ring_split_geometry(width: int) -> Tuple[int, int]:
    """(lane rows per split, splits per sequence) of the ring kernel: runs
    of ``RING_SPLIT_ROWS`` rows, a function of the lane width alone, so a
    row's result never depends on the rest of the batch."""
    return RING_SPLIT_ROWS, -(-width // RING_SPLIT_ROWS)


@functools.lru_cache(maxsize=None)
def _ring_lib() -> ctypes.CDLL:
    lib = build.load("flash_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ring_decode.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                ctypes.c_float, p]
    lib.ring_decode.restype = i
    return lib


def ring_decode_attention(q: torch.Tensor, k_lanes: torch.Tensor,
                          v_lanes: torch.Tensor, slots: torch.Tensor,
                          pos: torch.Tensor, *,
                          window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, dh); lanes: (S, KH, W, dh); slots: (B,) int32 lane of each
    row (each must name a lane); pos: (B,) int32 >= 0, the position of each
    row's current token, already written at ``pos % W`` -> (B, H, dh).

    Lane row j holds position ``pos - ((pos - j) mod W)``; it counts when
    that is >= 0 and, with a window, within ``window`` of pos. On the card
    the call launches the split kernel and, when the lane spans more than
    one split, the merge kernel; ``launches`` counts calls. Refuses operands
    that require grad (no backward)."""
    build.refuse_grad("ring_decode_attention", q, k_lanes, v_lanes)
    if build.plain_device(q):
        return ring_decode_attention_plain(q, k_lanes, v_lanes, slots, pos,
                                           window=window)
    what = "ring_decode_attention"
    build.require_cuda_operands(what, q, k_lanes, v_lanes, slots, pos)
    b, h, dh = q.shape
    _s, kh, w, ldh = k_lanes.shape
    if (v_lanes.shape != k_lanes.shape or ldh != dh or h % kh
            or slots.shape != (b,) or pos.shape != (b,)):
        raise ValueError(f"{what}: inconsistent shapes q={tuple(q.shape)} "
                         f"lanes={tuple(k_lanes.shape)} "
                         f"slots={tuple(slots.shape)} pos={tuple(pos.shape)}")
    if q.dtype not in build.DTYPE_CODES or k_lanes.dtype != q.dtype \
            or v_lanes.dtype != q.dtype:
        raise ValueError(f"{what}: q and lanes must share one dtype of "
                         f"{list(build.DTYPE_CODES)}")
    if slots.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{what}: slots and pos must be int32")
    if h // kh > MAX_GROUP or dh not in RING_HEAD_DIMS:
        raise ValueError(f"{what}: at most {MAX_GROUP} query heads per KV "
                         f"head and head_dim one of {RING_HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be positive")
    build.require_aligned(what, q, k_lanes, v_lanes)
    out = torch.empty_like(q)
    split_rows, splits = ring_split_geometry(w)
    scratch = (torch.empty(b * h * splits * (dh + 2), dtype=torch.float32,
                           device=q.device) if splits > 1 else None)
    lib = _ring_lib()
    code = lib.ring_decode(
        build.DTYPE_CODES[q.dtype], q.data_ptr(), k_lanes.data_ptr(),
        v_lanes.data_ptr(), slots.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, kh, h // kh, dh,
        w, window or 0, split_rows, dh ** -0.5,
        build.current_stream(q.device))
    build.check_launch(lib, code, what)
    ring_decode_attention.launches += 1
    return out


ring_decode_attention.launches = 0
