"""Computations each rank runs on its own shards: the contiguous cache's
per-row reads and writes, the embedding lookup (vocab-parallel), and
attention and the linear-attention scans (independent across rows and
heads, with query heads that may split where the KV heads do not).

A slot names a lane of the cache; under sharding the lanes' batch dim is
split over the batch axes, and a rank's slots are ids of its own lanes.
So the cache functions here run their plain counterparts on every rank's
local shards (``annotate.local_call``), after placing the new rows as the
lanes are placed. With ``kv_shard="seq"`` the lanes' length dim is split over
``model``: a rank writes the rows of its own run of the ring, and decode
attention over the runs is merged across ranks by their log-sum-exps (the
partial-softmax reduction the reference leaves to XLA). On plain tensors
every function is its plain counterpart, the kernel wrappers included.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_decode.ops import ring_decode_attention
from repro_torch.models.attention import (NEG_INF, attention,
                                          prefill_cache, update_cache)
from repro_torch.sharding.annotate import current_mesh_rules, local_call

# the dims of a (B, S, KH, dh) block of new rows that each dim of the
# (S, KH, W, dh) lanes holds
_ROWS_OF_LANES = {0: 0, 1: 2, 2: 1, 3: 3}


def _dtensor(x) -> bool:
    if current_mesh_rules() is None:       # the serving path: no import
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _place(x: torch.Tensor, ref: torch.Tensor, dims: dict) -> torch.Tensor:
    """``x`` placed as ``ref`` is, ``ref``'s tensor dim ``d`` read as
    ``x``'s dim ``dims[d]``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ref.device_mesh
    want = tuple(Shard(dims[p.dim]) if isinstance(p, Shard)
                 and dims.get(p.dim) is not None and mesh.size(i) > 1
                 else Replicate() for i, p in enumerate(ref.placements))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ref.device_mesh, want)


def _length_axes(lanes: torch.Tensor):
    """Mesh dims that split the lanes' length (dim 2)."""
    from torch.distributed.tensor import Shard
    mesh = lanes.device_mesh
    return [i for i, p in enumerate(lanes.placements)
            if isinstance(p, Shard) and p.dim == 2 and mesh.size(i) > 1]


def _run_start(lanes: torch.Tensor) -> int:
    """This rank's first lane row under a length split."""
    mesh = lanes.device_mesh
    start = 0
    for i in _length_axes(lanes):
        start = start * mesh.size(i) + mesh.get_local_rank(i)
    return start * lanes.to_local().shape[2]


def put_rows(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor
             ) -> None:
    """``dst[rows] = src`` in place (per-slot state, encoder lanes)."""
    if _dtensor(dst):
        src = _place(src, dst, {d: d for d in range(dst.ndim)})
    local_call(_index_put, dst, rows, src)


def _index_put(dst, rows, src):
    dst[rows.long()] = src


def take_rows(src: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``src[rows]``, placed as ``src`` is."""
    return local_call(_index, src, rows, like=src if _dtensor(src) else None)


def _index(src, rows):
    return src[rows.long()]


def write_prompt(lanes: torch.Tensor, slots: torch.Tensor,
                 new: torch.Tensor) -> None:
    """:func:`models.attention.prefill_cache`. Under a length split the
    prompt's last W rows must start a ring turn (S a multiple of W), so
    that each rank's run takes a run of them."""
    if not _dtensor(lanes):
        return prefill_cache(lanes, slots, new)
    s, w = new.shape[1], lanes.shape[2]
    if _length_axes(lanes):
        if s % w:
            raise NotImplementedError(
                f"a length-split cache takes prompts of a multiple of its "
                f"{w} rows (got {s})")
        new = new[:, s - w:]
    local_call(prefill_cache, lanes, slots, _place(new, lanes,
                                                   _ROWS_OF_LANES))


def write_token(lanes: torch.Tensor, slots: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """:func:`models.attention.update_cache`; under a length split only
    the rank whose run holds ring row ``pos % W`` writes it."""
    if not _dtensor(lanes):
        return update_cache(lanes, slots, new, pos)
    if not _length_axes(lanes):
        new = _place(new, lanes, {0: 0, 1: 1, 3: 2})  # (B, KH, dh) rows
        return local_call(update_cache, lanes, slots, new, pos)
    local_call(_update_run, lanes, slots, _batch_only(new, lanes), pos,
               start=_run_start(lanes), width=lanes.shape[2])


def _batch_only(x: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``x`` placed with the lanes' batch split alone."""
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in lanes.placements)
    return x if tuple(x.placements) == want else x.redistribute(
        lanes.device_mesh, want)


def _update_run(lanes, slots, new, pos, *, start: int, width: int):
    """Write ``new`` at ring row ``pos % width`` where this rank's run
    ``[start, start + W_run)`` holds it (the others keep their rows)."""
    run = lanes.shape[2]
    at = pos.long() % width - start
    mine = (at >= 0) & (at < run)
    idx = slots.long()
    at = torch.clamp(at, 0, run - 1)
    old = lanes[idx, :, at]
    lanes[idx, :, at] = torch.where(mine[:, None, None], new, old)


def ring_decode(q: torch.Tensor, k_lanes: torch.Tensor,
                v_lanes: torch.Tensor, slots: torch.Tensor, pos: torch.Tensor,
                *, window: Optional[int] = None) -> torch.Tensor:
    """:func:`kernels.flash_decode.ops.ring_decode_attention`; its plain
    version on each rank's lanes under sharding, and across a length split
    each rank's run attended alone and the runs merged."""
    if not _dtensor(k_lanes):
        return ring_decode_attention(q, k_lanes, v_lanes, slots, pos,
                                     window=window)
    if not _length_axes(k_lanes):
        q = _place(q, k_lanes, {0: 0, 1: 1, 2: None, 3: 2})
        return local_call(ring_decode_attention, q, k_lanes, v_lanes, slots,
                          pos, window=window, like=q)
    return _merged_runs(_batch_only(q, k_lanes), k_lanes, v_lanes, slots,
                        pos, window=window)


def _merged_runs(q, k_lanes, v_lanes, slots, pos, *, window):
    from torch.distributed.tensor import DTensor, Partial, Replicate

    axes = _length_axes(k_lanes)
    out, lse = local_call(_run_attention, q, k_lanes, v_lanes, slots, pos,
                          window=window, start=_run_start(k_lanes),
                          width=k_lanes.shape[2])
    mesh = k_lanes.device_mesh

    def over(reduce, x):
        placed = tuple(Partial(reduce) if i in axes else p
                       for i, p in enumerate(q.placements))
        whole = tuple(Replicate() if i in axes else p
                      for i, p in enumerate(q.placements))
        return DTensor.from_local(x, mesh, placed, run_check=False
                                  ).redistribute(mesh, whole).to_local()
    top = over("max", lse)
    weight = torch.exp(lse - top)
    num = over("sum", out * weight[..., None])
    den = over("sum", weight)
    return DTensor.from_local((num / den[..., None]).to(q.dtype), mesh,
                              q.placements, run_check=False)


def _run_attention(q, k_lanes, v_lanes, slots, pos, *, window, start: int,
                   width: int):
    """Decode attention over lane rows ``[start, start + W_run)`` of rings
    of ``width`` rows: ``(out (B, H, dh) f32, log-sum-exp (B, H) f32)``,
    the softmax normalised over the run alone."""
    idx = slots.long()
    k, v = k_lanes[idx].float(), v_lanes[idx].float()     # (B, KH, W_run, dh)
    b, h, dh = q.shape
    kh, run = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kh, h // kh, dh)
    s = torch.einsum("bkgd,bkwd->bkgw", qg, k) * dh ** -0.5
    j = torch.arange(start, start + run, device=q.device)
    p = pos.long()[:, None]
    held = p - torch.remainder(p - j[None], width)       # (B, W_run)
    valid = held >= 0
    if window is not None:
        valid = valid & (p - held < window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    out = torch.einsum("bkgw,bkwd->bkgd", e, v) / l[..., None]
    return out.reshape(b, h, dh), (m + torch.log(l)).reshape(b, h)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``. Under sharding each rank looks up its own ids in its
    own run of the table's rows (zeros for ids outside it), and the
    partial sums are reduced where the caller places the result: a
    vocab-parallel embedding. Its backward writes each rank's rows alone,
    and the table's gradient is a partial sum over the ranks that split
    the ids."""
    if not _dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows = [i for i, p in enumerate(table.placements)
            if isinstance(p, Shard) and p.dim == 0 and mesh.size(i) > 1]
    start = 0
    for i in rows:
        start = start * mesh.size(i) + mesh.get_local_rank(i)
    start *= table.to_local().shape[0]
    id_places = (tuple(ids.placements) if isinstance(ids, DTensor)
                 else (Replicate(),) * mesh.ndim)
    out = tuple(Partial() if i in rows else p
                for i, p in enumerate(id_places))
    grad = tuple(p if i in rows else Partial() if isinstance(id_places[i],
                                                             Shard)
                 else Replicate() for i, p in enumerate(table.placements))

    def run(table, ids):
        n = table.shape[0]
        local = ids.long() - start
        inside = (local >= 0) & (local < n)
        rows_ = table[torch.clamp(local, 0, n - 1)]
        return torch.where(inside[..., None], rows_,
                           torch.zeros_like(rows_))
    return local_map(run, out_placements=list(out),
                     in_placements=(tuple(table.placements),
                                    id_places if isinstance(ids, DTensor)
                                    else None),
                     in_grad_placements=(grad, id_places),
                     device_mesh=mesh)(
                         table, ids)


def rows_and_heads(fn, args, dims, ref: int, out_dims, **kwargs):
    """``fn(*args, **kwargs)`` for a computation independent across rows and
    heads: ``dims[i]`` is ``(row dim, head dim)`` of argument i (either may
    be None), ``out_dims`` the same for each output. Under sharding it runs
    on each rank's own rows and heads (``local_map``): every argument is
    placed as ``args[ref]`` splits its rows and heads, and so is each
    output. Attention and the linear-attention scans run so: DTensor
    would otherwise split their einsums' merged batch dims itself, which it
    cannot always do."""
    lead = args[ref]
    if not _dtensor(lead):
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = lead.device_mesh
    row, head = dims[ref]
    kinds = [0 if isinstance(p, Shard) and p.dim == row else
             1 if isinstance(p, Shard) and p.dim == head else None
             for p in lead.placements]

    def place(dim):
        return tuple(Replicate() if k is None or dim[k] is None
                     else Shard(dim[k]) for k in kinds)
    many = isinstance(out_dims, list)
    return local_map(
        functools.partial(fn, **kwargs),
        out_placements=(tuple(place(d) for d in out_dims) if many
                        else list(place(out_dims))),
        in_placements=tuple(place(d) if isinstance(a, DTensor) else None
                            for a, d in zip(args, dims)),
        device_mesh=mesh, redistribute_inputs=True)(*args)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           pos_q: torch.Tensor, pos_kv: torch.Tensor, **kw) -> torch.Tensor:
    """:func:`models.attention.attention` (q: (B, Sq, H, dh), k/v: (B, Skv,
    KH, dh)). Where q's heads are split over a mesh axis that leaves the KV
    heads whole (64 query heads over 16 ranks, 8 KV heads), a shard of the
    heads cuts a KV group, which no view of q can express: each rank then
    attends its own query heads to the KV head(s) they read
    (``local_map``), and the output stays placed as q is."""
    if not _dtensor(q):
        return attention(q, k, v, pos_q, pos_kv, **kw)
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    split = [i for i, (a, b) in enumerate(zip(q.placements, k.placements))
             if isinstance(a, Shard) and a.dim == 2 and mesh.size(i) > 1
             and not (isinstance(b, Shard) and b.dim == 2)]
    if not split:
        return rows_and_heads(attention, (q, k, v, pos_q, pos_kv),
                              ((0, 2),) * 3 + ((0, None),) * 2, 0, (0, 2),
                              **kw)
    h, kh = q.shape[2], k.shape[2]
    group, parts = h // kh, 1
    first = 0
    for i in range(mesh.ndim):
        if isinstance(q.placements[i], Shard) and q.placements[i].dim == 2:
            parts *= mesh.size(i)
            first = first * mesh.size(i) + mesh.get_local_rank(i)
    local_h = h // parts
    if group % local_h and local_h % group:
        raise NotImplementedError(f"{h} query heads over {parts} ranks cut "
                                  f"their {kh} KV groups unevenly")
    start = first * local_h // group
    count = max(1, local_h // group)

    def run(q, k, v, pos_q, pos_kv):
        return attention(q, k[:, :, start:start + count],
                         v[:, :, start:start + count], pos_q, pos_kv, **kw)
    placements = [tuple(t.placements) if isinstance(t, DTensor) else None
                  for t in (q, k, v, pos_q, pos_kv)]
    return local_map(run, out_placements=list(placements[0]),
                     in_placements=tuple(placements), device_mesh=mesh)(
                         q, k, v, pos_q, pos_kv)
