"""Attention: the plain reference and the LM's kernel-backed paths.

Port of ``repro/models/attention.py``.

* :func:`attention_naive` is the reference's plain attention (GQA, causal /
  bidirectional / sliding-window masks from absolute positions, operands in
  their storage dtype with f32 accumulation and f32 softmax, finite
  ``NEG_INF``). The ranking predictor uses it, and the tests hold the kernel
  paths against it. :func:`attention_chunked` (online softmax over KV
  chunks) and the dispatcher :func:`attention` are the reference's other
  XLA path; with the naive form they carry the LM's training forward,
  which needs gradients the kernels do not have.
* The LM's attention runs on the hand-written kernels:
  :func:`prefill_attention` (first prefill chunks over their own K/V, and
  continuation chunks at per-row offsets over a gathered lane), and one
  token per sequence through the paged decode kernel
  (``kernels.flash_decode.ops.paged_decode_attention``, read straight out
  of the block pool) or the ring decode kernel
  (``kernels.flash_decode.ops.ring_decode_attention``, read straight out of
  the sequence's lane). :func:`decode_attention` is the ring kernel's plain
  version.

The LM's KV cache is paged or contiguous. Paged: one pool per layer,
``(N+1, bs, KH, dh)`` with the KV heads inside each row, addressed through
per-sequence block tables; :func:`write_paged` scatters new K/V rows into a
pool and :func:`gather_lane` lays a table's rows out as one contiguous lane.
Contiguous: one lane per slot and layer, ``(S, KH, W, dh)`` heads first, an
append buffer until it wraps as a ring; :func:`prefill_cache` and
:func:`update_cache` write prompt and decode rows at their ring slots, in
place (the reference's functions return new arrays).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_prefill.ops import flash_attention

NEG_INF = -1e30


def _mask(pos_q: torch.Tensor, pos_kv: torch.Tensor, *, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """Validity mask (B, S_q, S_kv) from absolute positions. Negative kv
    positions are invalid (unwritten slots, PAD tokens)."""
    m = (pos_kv[:, None, :] >= 0).expand(-1, pos_q.shape[1], -1)
    if causal:
        m = m & (pos_kv[:, None, :] <= pos_q[:, :, None])
    if window is not None:
        m = m & (pos_q[:, :, None] - pos_kv[:, None, :] < window)
    return m


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,dh), k/v: (B,Skv,KH,dh) -> (B,Sq,H,dh).

    Products of storage-dtype operands accumulate in f32 (an upcast before
    the einsum is exact for bf16 products); probabilities round to V's dtype
    before weighting V, as the reference's ``probs.astype(v.dtype)``."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * d ** -0.5
    mask = _mask(pos_q, pos_kv, causal=causal, window=window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV in chunks of ``kv_chunk`` (the
    reference's flash-style XLA path, a Python loop where it scans).

    Peak live memory: (B,KH,G,Sq,kv_chunk) scores instead of (...,S_kv);
    running max and sum in f32. Ragged sizes take :func:`attention_naive`,
    as the reference does. Plain and differentiable: the LM's training
    path."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if skv % kv_chunk != 0:
        return attention_naive(q, k, v, pos_q, pos_kv, causal=causal,
                               window=window)
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d).permute(0, 2, 3, 1, 4).float()
    scale = d ** -0.5
    # made like qg, so that under sharding they are placed as it is
    m = torch.full_like(qg[..., :1], NEG_INF)
    l = torch.zeros_like(qg[..., :1])
    acc = torch.zeros_like(qg)
    for c0 in range(0, skv, kv_chunk):
        kc, vc = k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk]
        s = torch.einsum("bkgqd,bckd->bkgqc", qg, kc.float()) * scale
        mask = _mask(pos_q, pos_kv[:, c0:c0 + kv_chunk], causal=causal,
                     window=window)
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgqc,bckd->bkgqd",
                                        p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pos_q: torch.Tensor, pos_kv: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              impl: str = "chunked", kv_chunk: int = 1024) -> torch.Tensor:
    """The reference's dispatcher: :func:`attention_naive` when
    ``impl == "naive"`` or the keys fit one chunk, else
    :func:`attention_chunked`."""
    if impl == "naive" or k.shape[1] <= kv_chunk:
        return attention_naive(q, k, v, pos_q, pos_kv, causal=causal,
                               window=window)
    return attention_chunked(q, k, v, pos_q, pos_kv, causal=causal,
                             window=window, kv_chunk=kv_chunk)


# ---------------------------------------------------------------------------
# Paged KV: pools, tables, lanes
# ---------------------------------------------------------------------------
def write_paged(pool: torch.Tensor, tables: torch.Tensor,
                positions: torch.Tensor, new: torch.Tensor) -> None:
    """Write K or V rows into one layer's pool, in place.

    pool: (N+1, bs, KH, dh); tables: (B, max_blocks) int; positions: (B, S)
    absolute token positions; new: (B, S, KH, dh). Position p of row b lands
    in block ``tables[b, (p % W) // bs]`` at offset ``p % bs``, with
    ``W = max_blocks * bs`` (a decode past W wraps onto the row's own oldest
    block, the reference's ring semantics)."""
    bs = pool.shape[1]
    slot = positions.long() % (tables.shape[1] * bs)
    blocks = torch.gather(tables.long(), 1, slot // bs)
    pool[blocks.reshape(-1), (slot % bs).reshape(-1)] = \
        new.reshape(-1, *new.shape[2:])


def gather_lane(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(N+1, bs, KH, dh) pool, (B, max_blocks) tables -> (B, KH, W, dh)
    contiguous lanes (the prefill kernel's K/V layout)."""
    b, mb = tables.shape
    bs, kh, dh = pool.shape[1:]
    lane = pool[tables.long()].reshape(b, mb * bs, kh, dh)
    return lane.permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# Contiguous KV: per-slot lanes, append buffers or rings
# ---------------------------------------------------------------------------
def ring_slot_positions(pos: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Absolute position held by each slot of a ring of ``cache_len``
    slots, -1 where unwritten. ``pos`` (B,) is the position of the token
    being decoded *now*; slots hold positions < pos (slot j holds the
    largest p < pos with p % cache_len == j). Returns (B, cache_len)."""
    j = torch.arange(cache_len, dtype=torch.int64, device=pos.device)
    p = pos.long()[:, None] - 1 - torch.remainder(
        pos.long()[:, None] - 1 - j[None, :], cache_len)
    return torch.where(p >= 0, p, torch.full_like(p, -1))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention: the plain version of the ring decode kernel.

    q: (B, H, dh); caches: (B, W, KH, dh); pos: (B,) int, the position of
    each row's current token, whose K/V the caller has already written at
    slot ``pos % W``. The caches are append buffers while pos < W and rings
    after; a window masks keys at ``pos - p >= window``."""
    w = k_cache.shape[1]
    slot_pos = ring_slot_positions(pos.long() + 1, w)   # includes current
    pos_q = pos.long()[:, None]
    out = attention_naive(q[:, None], k_cache, v_cache, pos_q, slot_pos,
                          causal=True, window=window)
    return out[:, 0]


def update_cache(lanes: torch.Tensor, slots: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write one token's K or V per row into its ring slot, in place.

    lanes: (S, KH, W, dh), one layer of the heads-first lanes; slots: (B,)
    lane of each row; new: (B, KH, dh); pos: (B,) absolute positions (slot
    ``pos % W``)."""
    w = lanes.shape[2]
    lanes[slots.long(), :, pos.long() % w] = new


def prefill_cache(lanes: torch.Tensor, slots: torch.Tensor,
                  new: torch.Tensor) -> None:
    """Write a prompt's K or V (positions ``0 .. S-1``) into the lanes of
    ``slots``, in place. new: (B, S, KH, dh). A prompt longer than the lane
    keeps its last W positions, each at slot ``position % W``, so that
    decode continues the ring seamlessly (the reference's
    ``prefill_cache``); lane rows past S keep whatever they held, which
    decode masks as unwritten."""
    s, w = new.shape[1], lanes.shape[2]
    first = max(0, s - w)
    ring = torch.arange(first, s, device=new.device) % w
    rows = slots.long()[:, None]
    lanes[rows, :, ring[None, :]] = new[:, first:]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_start: torch.Tensor, kv_len: torch.Tensor, *,
                      causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention on the prefill kernel, causal unless told not to
    be (an encoder's self-attention, cross-attention onto its rows).

    q: (B, S, H, dh) at absolute positions ``q_start[b] + i``; k/v:
    (B, KH, Skv, dh) lanes holding positions ``0 .. Skv-1``; keys at
    positions >= ``kv_len[b]`` are masked; the softmax scale ``scale``, or
    ``dh ** -0.5``. Returns (B, S, H, dh)."""
    out = flash_attention(q.transpose(1, 2).contiguous(), k, v,
                          q_start.to(torch.int32), kv_len.to(torch.int32),
                          causal=causal, window=window, scale=scale)
    return out.transpose(1, 2)

