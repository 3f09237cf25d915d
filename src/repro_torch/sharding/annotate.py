"""Logical-axis sharding annotations.

Port of ``repro/sharding/annotate.py``. Model code tags activations with
*logical* axis names ("batch", "heads", "expert", ...). A rules context maps
logical names to the axes of a mesh; outside any rules context the tags are
no-ops, so the same model code runs unsharded on plain tensors and sharded
under DTensor on a production mesh, where a tag redistributes the
activation to the placements its names resolve to.

Non-divisible dims are silently left unsharded (e.g. a decode step with one
MoE group under a 16-way axis), as the reference leaves them.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or (for computing specs without a process group) a mapping of axis name to
size. Specs are :class:`PartitionSpec` tuples: one entry per tensor dim,
``None``, an axis name, or a tuple of axis names.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

_CTX = threading.local()

Axes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: a tuple with one entry per
    tensor dim (``None``, an axis name, or a tuple of axis names)."""

    def __new__(cls, *parts: Axes):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def to_placements(spec: Sequence[Axes], mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim wider than 1 that tensor dim ``d`` names (a tuple of axes
    gives ``Shard(d)`` on each of them, in order), ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, part in enumerate(spec):
        for axis in ((part,) if isinstance(part, str) else (part or ())):
            where[axis] = dim
    # a split over a 1-wide axis is no split
    return tuple(Shard(where[a]) if a in where and n > 1 else Replicate()
                 for a, n in zip(mesh.mesh_dim_names, mesh.shape))


def _state():
    if not hasattr(_CTX, "stack"):
        _CTX.stack = []
    return _CTX.stack


@contextmanager
def logical_axis_rules(mesh, rules: Dict[str, Axes]):
    """Activate a logical→physical mapping for ``with_sharding`` tags."""
    _state().append((mesh, rules))
    try:
        yield
    finally:
        _state().pop()


def current_mesh_rules() -> Optional[Tuple[object, Dict[str, Axes]]]:
    st = _state()
    return st[-1] if st else None


def resolve_spec(logical: Sequence[Axes], shape, mesh,
                 rules: Dict[str, Axes]) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, dropping non-divisible
    dims and axes an earlier dim already took."""
    sizes = mesh_axes(mesh)
    out = []
    used: set = set()
    for dim, name in enumerate(logical):
        phys = rules.get(name) if isinstance(name, str) else None
        if phys is None:
            out.append(None)
            continue
        axes = (phys,) if isinstance(phys, str) else tuple(phys)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if size > 1 and shape[dim] % size == 0:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return PartitionSpec(*out)


def splits(name: str, size: int) -> bool:
    """Whether the logical axis ``name`` shards a dim of ``size`` under the
    active rules (False outside a rules context)."""
    ctx = current_mesh_rules()
    if ctx is None:
        return False
    mesh, rules = ctx
    return resolve_spec((name,), (size,), mesh, rules)[0] is not None


def with_sharding(x: torch.Tensor, logical: Sequence[Axes]) -> torch.Tensor:
    """Tag an intermediate with logical axes: ``x`` itself outside a rules
    context; otherwise ``x`` redistributed to the placements the names
    resolve to. A plain tensor (one the model made, such as positions) is
    taken as replicated, as ``implicit_replication`` takes it, so placing
    it only slices it; where nothing resolves to a mesh axis it stays as it
    is."""
    ctx = current_mesh_rules()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh, rules = ctx
    spec = resolve_spec(logical, x.shape, mesh, rules)
    if not isinstance(x, DTensor):
        if all(p is None for p in spec):
            return x
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def local_call(fn, *args, like=None, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's local shards, for the cache's
    per-row reads and writes: a slot indexes its rank's own lanes, which a
    batch-sharded cache holds. DTensor arguments pass their local tensors
    (so they must be placed alike on the batch axes); the result is placed
    as the DTensor ``like`` is, or returned as it is (an in-place write).
    Outside a rules context, or without DTensor arguments, the call
    itself."""
    if current_mesh_rules() is None:
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args, **kwargs)
    out = fn(*(a.to_local() if isinstance(a, DTensor) else a for a in args),
             **kwargs)
    if like is None:
        return out
    return DTensor.from_local(out, like.device_mesh, like.placements,
                              run_check=False)


class _GradPlacedAs(torch.autograd.Function):
    """The identity, whose backward places the gradient as the input is
    placed: each layer's gradient is reduced to its parameter's placement
    before the layers' gradients are stacked, so DTensor never picks a
    layout for the stack (one that would depend on the depth)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.placements:
            return grad
        return grad.redistribute(ctx.mesh, ctx.placements)


def gather_fsdp(tree):
    """Parameters as a layer uses them: every DTensor leaf sharded over the
    ``"fsdp"`` axes is all-gathered over them (its tensor-parallel dims stay
    sharded), so products run on whole rows and their gradients flow back
    as a reduce-scatter: the FSDP program; every leaf's gradient comes back
    placed as the leaf is. Outside a rules context, or for plain tensors,
    the tree as it is."""
    ctx = current_mesh_rules()
    if ctx is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate

    mesh, rules = ctx
    fsdp = rules.get("fsdp") or ()
    fsdp = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp)

    def gather(x):
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        if not isinstance(x, DTensor):
            return x
        if x.requires_grad:
            x = _GradPlacedAs.apply(x)
        placements = tuple(Replicate() if name in fsdp else p for name, p in
                           zip(mesh.mesh_dim_names, x.placements))
        if placements == tuple(x.placements):
            return x
        return x.redistribute(mesh, placements)
    return gather(tree)


# Default logical→physical mapping for the production meshes.
# "data"-like axes absorb the "pod" axis when it exists.
DEFAULT_RULES: Dict[str, Axes] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),        # param FSDP dim
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "expert": "model",
    "vocab": "model",
    "moe_group": ("data", "model"),  # dispatch groups, fully token-sharded
    "moe_group_dp": ("pod", "data"), # groups in the (G,E,C,d) expert layout
    "seq": None,                     # sequence kept unsharded (no CP here)
    "d_inner": "model",              # SSM inner channels
}
