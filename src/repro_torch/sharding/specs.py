"""Parameter / activation / cache partition specs for the production meshes.

Port of ``repro/sharding/specs.py``. Policy: tensor-parallel dims (heads,
ff, experts, vocab) shard over ``model``; one non-TP matrix dim shards over
the FSDP axes (``data`` or ``("pod","data")``); everything indivisible or
tiny is replicated. Specs are derived *by leaf path name* (the port's trees
are nested dicts with the reference's keys), so every family is covered by
one rule table. The results are :class:`~repro_torch.sharding.annotate.
PartitionSpec` tuples; :func:`to_placements` turns one into DTensor
placements and :func:`shard_meta` a tree into meta DTensors.

``decode_cache_specs`` has the reference's two modes: ``kv_shard="heads"``
(the KV-head dim over ``model``, dropped where indivisible) and
``kv_shard="seq"`` (the cache length over ``model``). The port's cache is
laid out differently from the reference's (lanes heads first, per-row
``slots`` and ``pos``), so its rules name dims, not positions
(:data:`CACHE_DIMS`).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import torch

from repro_torch.bridge import flatten, unflatten
from repro_torch.sharding.annotate import (PartitionSpec, mesh_axes,
                                           to_placements)

P = PartitionSpec
Tree = Dict[str, Any]

__all__ = ["P", "PartitionSpec", "param_specs", "batch_specs",
           "decode_cache_specs", "replicated", "to_placements", "shard_meta",
           "local_shape", "CACHE_DIMS"]

# leaf-name regex -> logical spec template, aligned to the LAST ndims of the
# leaf (leading stacked-layer axes are padded with None automatically).
# Axis vocabulary: "fsdp" | "model" | None.
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embeddings / heads
    (r"(^|/)embed$",            ("model", "fsdp")),     # (V, d)
    (r"(^|/)lm_head$",          ("fsdp", "model")),     # (d, V)
    (r"(^|/)pos_embed$",        (None, "fsdp")),
    # attention
    (r"/attn/w[qkv]$",          ("fsdp", "model")),
    (r"/attn/wo$",              ("model", "fsdp")),
    (r"/cross/w[qkv]$",         ("fsdp", "model")),
    (r"/cross/wo$",             ("model", "fsdp")),
    # dense MLP
    (r"/mlp/w_(up|gate)$",      ("fsdp", "model")),
    (r"/mlp/w_down$",           ("model", "fsdp")),
    # MoE
    (r"/moe/router$",           ("fsdp", "model")),     # (d, E)
    (r"/moe/w_(up|gate)$",      ("model", "fsdp", None)),  # (E, d, f)
    (r"/moe/w_down$",           ("model", None, "fsdp")),  # (E, f, d)
    # RWKV time-mix / channel-mix
    (r"/tm/w_[rkvg]$",          ("fsdp", "model")),
    (r"/tm/w_o$",               ("model", "fsdp")),
    (r"/tm/decay_a$",           ("fsdp", None)),
    (r"/tm/decay_b$",           (None, "model")),
    (r"/cm/w_[kr]$",            ("fsdp", "model")),
    (r"/cm/w_v$",               ("model", "fsdp")),
    # SSD/Mamba (hybrid)
    (r"/ssm/w_in$",             ("fsdp", "model")),
    (r"/ssm/conv$",             (None, "model")),
    (r"/ssm/w_(bc|dt)$",        ("model", None)),
    (r"/ssm/w_out$",            ("model", "fsdp")),
)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def batch_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = mesh_axes(mesh)
    axes = (axes,) if isinstance(axes, str) else axes
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _resolve(template, shape, mesh, *, fsdp: bool = True) -> PartitionSpec:
    """Logical template → PartitionSpec, padded to ndim, divisibility-checked.

    ``fsdp=False`` drops the FSDP dim (params replicated over the data axes:
    the TP-only layout of weight-resident decode).
    """
    sizes = mesh_axes(mesh)
    tpl = (None,) * (len(shape) - len(template)) + tuple(template)
    out, used = [], set()
    for dim, name in zip(shape, tpl):
        if name is None or (name == "fsdp" and not fsdp):
            out.append(None)
            continue
        axes = fsdp_axes(mesh) if name == "fsdp" else ("model",)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        if axes and dim % _axis_size(mesh, axes) == 0:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return P(*out)


def _map(fn, tree: Tree) -> Tree:
    """``fn(path, leaf)`` over a nested dict's leaves, paths "a/b/c"."""
    return unflatten({k: fn(k, v) for k, v in flatten(tree).items()})


def param_specs(params_shape: Tree, mesh, *, fsdp: bool = True) -> Tree:
    """PartitionSpec tree for a params tree (tensors of any device)."""
    def spec_for(name, leaf):
        for pat, tpl in _RULES:
            if re.search(pat, name):
                return _resolve(tpl, leaf.shape, mesh, fsdp=fsdp)
        return P()                               # replicate (norms, scalars…)
    return _map(spec_for, params_shape)


def batch_specs(batch_shape: Tree, mesh) -> Tree:
    """Shard every batch leaf's batch dim over (pod, data).

    Handles the (3, B, S) mrope-positions layout (batch at axis 1).
    """
    ba = batch_axes(mesh)

    def spec_for(name, leaf):
        bdim = 1 if name.endswith("mrope_positions") else 0
        spec = [None] * len(leaf.shape)
        if leaf.shape[bdim] % _axis_size(mesh, ba) == 0:
            spec[bdim] = ba if len(ba) > 1 else ba[0]
        return P(*spec)
    return _map(spec_for, batch_shape)


# The named dims of each leaf of the port's contiguous cache
# (``models.transformer.init_cache``). The reference's leaves are (L, B, W,
# KH, dh) lanes, (L, B, ...) state and a scalar pos; the port's lanes are
# heads first and it keeps per-row ``slots`` and ``pos``.
CACHE_DIMS: Dict[str, Tuple[str, ...]] = {
    "k": ("layer", "batch", "kv_heads", "length", "head_dim"),
    "v": ("layer", "batch", "kv_heads", "length", "head_dim"),
    "cross_k": ("layer", "batch", "kv_heads", "length", "head_dim"),
    "cross_v": ("layer", "batch", "kv_heads", "length", "head_dim"),
    "state": ("layer", "batch", "heads", "key", "value"),
    "ssm_state": ("layer", "batch", "heads", "state", "head_dim"),
    "conv_tail": ("layer", "batch", "tail", "d_inner"),
    "tm_prev": ("layer", "batch", "d_model"),
    "cm_prev": ("layer", "batch", "d_model"),
    "slots": ("batch",),
    "pos": ("batch",),
}


def decode_cache_specs(cache_shape: Tree, mesh, *,
                       kv_shard: str = "heads") -> Tree:
    """Specs of the port's contiguous cache, by named dim
    (:data:`CACHE_DIMS`), with the reference's rules:

    * the batch dim over (pod, data) where divisible;
    * K/V lanes (self and cross): the KV-head dim (``"heads"``) or the
      length dim (``"seq"``) over ``model`` where divisible;
    * the recurrent state's heads dim and the conv tail's ``d_inner`` dim
      over ``model`` only where the reference's patterns match the leaf's
      path: they need a ``/`` before ``state``, ``ssm_state`` or
      ``conv_tail``, and the cache's keys are top-level, so (as in the
      reference) those leaves shard on batch alone.

    The per-row ``slots`` and ``pos`` go with their rows (the reference's
    scalar ``pos`` is replicated). A paged cache has no reference layout
    and is refused."""
    if kv_shard not in ("heads", "seq"):
        raise ValueError(f"kv_shard={kv_shard!r}: 'heads' or 'seq'")
    if "tables" in cache_shape:
        raise ValueError("decode_cache_specs: the reference's cache is "
                         "contiguous; build it with paged=False")
    ba = batch_axes(mesh)
    msize = mesh_axes(mesh).get("model", 1)

    def spec_for(name, leaf):
        dims = CACHE_DIMS[name]
        if len(dims) != leaf.ndim:
            raise ValueError(f"cache leaf {name!r}: {leaf.ndim} dims, "
                             f"expected {dims}")
        size = dict(zip(dims, leaf.shape))
        spec = {}
        if size["batch"] % _axis_size(mesh, ba) == 0:
            spec["batch"] = ba if len(ba) > 1 else ba[0]
        if re.search(r"(^|/)(k|v|cross_k|cross_v)$", name):
            if kv_shard == "seq" and size["length"] % msize == 0:
                spec["length"] = "model"
            elif kv_shard == "heads" and size["kv_heads"] % msize == 0:
                spec["kv_heads"] = "model"
        elif re.search(r"/(state|ssm_state)$", name):
            if size["heads"] % msize == 0:
                spec["heads"] = "model"
        elif re.search(r"/conv_tail$", name):
            if size["d_inner"] % msize == 0:
                spec["d_inner"] = "model"
        return P(*(spec.get(d) for d in dims))
    return _map(spec_for, cache_shape)


def replicated(mesh) -> PartitionSpec:
    return P()


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The per-rank shape of a tensor of global ``shape`` under ``spec``."""
    return tuple(n // _axis_size(mesh, part) for n, part in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def shard_meta(tree: Tree, specs: Tree, mesh) -> Tree:
    """Meta DTensors for a tree of tensors (any device; only shapes and
    dtypes are read): each leaf's local shard is an empty ``meta`` tensor of
    its per-rank shape, placed as its spec says (``DTensor.from_local``)."""
    from torch.distributed.tensor import DTensor

    flat_specs = flatten(specs)

    def place(name, leaf):
        spec = flat_specs[name]
        local = torch.empty(local_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device="meta")
        return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                                  run_check=False, shape=leaf.shape,
                                  stride=_contiguous_stride(leaf.shape))
    return _map(place, tree)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
