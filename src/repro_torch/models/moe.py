"""Mixture-of-Experts FFN with the reference's capacity-bounded dispatch.

Port of ``repro/models/moe.py``. Tokens are split into groups of ``tg =
min(group_size, tokens)`` consecutive (row-major) tokens; in each group an
expert takes at most ``C = max(8, ceil8(tg * top_k * capacity_factor /
E))`` token-slots. Positions within an expert are counted slot-major (every
token's first choice in token order, then every token's second, ...), and a
slot at position C or later is dropped: its gate weight, normalised over
the k choices before the drop, is lost, not redistributed. So a token's
output depends on every other token of its group.

The reference builds ``(G, T, E, C)`` one-hot dispatch and combine tensors
and contracts them with einsums. The port computes the same function by
index: each kept slot's token is copied into row ``pos`` of its (expert,
group) block of ``min(C, tg)`` rows, one batched product per projection
runs every expert over its rows (rows that no token took stay zero, as the
reference's empty capacity does), and each token sums its kept slots'
outputs weighted by their gates. The width is exact: a token's k choices
are distinct, so a group of ``tg`` tokens sends an expert at most ``tg``
slots and ``pos < tg`` always (a one-token decode group fills one row per
expert, not C). These are plain large products, outside any kernel in
both.

The router is the reference's softmax over the experts, or, with
:class:`SigmoidRouting` (DeepSeek-V3's ``noaux_tc`` in one group,
arXiv:2412.19437 §2.1.2), a sigmoid score per expert: the top k of the
scores plus a per-expert ``router_bias`` are chosen (the bias moves the
choice only), and their gates are their scores, normalised over the k,
times ``routed_scaling_factor``; its logits take the
router's f32 weights as they are, as the published model computes its gate
in f32 (the softmax router rounds them to the activation dtype first, as
the reference does). Both choose with a stable sort, ties to the lower
index.

The four stages are the tracer's spans (``repro_torch.trace``):
``moe.router``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``, so a
profile with host activity attributes the device time of each stage's
kernels.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import activate, dense_init, gated
from repro_torch.sharding.annotate import (current_mesh_rules, resolve_spec,
                                           with_sharding)


class SigmoidRouting(NamedTuple):
    """A sigmoid router's gates: scaled by ``routed_scaling_factor`` after
    a normalisation over the chosen k."""
    routed_scaling_factor: float


def routing_of(cfg) -> Optional[SigmoidRouting]:
    """The router of a model config: :class:`SigmoidRouting` for a
    ``scoring="sigmoid"`` config (``configs/latent.py``), None for the
    softmax router."""
    if getattr(cfg, "scoring", "softmax") != "sigmoid":
        return None
    return SigmoidRouting(cfg.routed_scaling_factor)


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig,
             activation: str, dtype: torch.dtype, num_layers: int,
             router_bias: bool = False) -> dict:
    """Stacked expert parameters: an f32 ``router`` (L, d, E) and the
    experts' ``w_up``/``w_gate`` (L, E, d, f) and ``w_down`` (L, E, f, d);
    with ``router_bias`` a sigmoid router's f32 selection bias (L, E),
    zeros."""
    e, f, L = moe.num_experts, moe.expert_d_ff, num_layers
    p = {"router": dense_init(gen, (L, d_model, e), in_axis_size=d_model,
                              dtype=torch.float32),
         "w_up": dense_init(gen, (L, e, d_model, f), in_axis_size=d_model,
                            dtype=dtype),
         "w_down": dense_init(gen, (L, e, f, d_model), in_axis_size=f,
                              dtype=dtype)}
    if gated(activation):
        p["w_gate"] = dense_init(gen, (L, e, d_model, f),
                                 in_axis_size=d_model, dtype=dtype)
    if router_bias:
        p["router_bias"] = torch.zeros(L, e, dtype=torch.float32,
                                       device=gen.device)
    return p


def _capacity(group_size: int, moe: MoEConfig) -> int:
    c = int(group_size * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8, min 8


def groups_of(b: int, s: int, moe: MoEConfig,
              per_row: bool = False) -> Tuple[int, int]:
    """``(tg, g)``: the group size and the number of groups of a dispatch
    of ``b`` rows of ``s`` tokens (``per_row``: each row a dispatch of its
    own)."""
    tg = min(moe.group_size, s if per_row else b * s)
    return tg, b * s // tg


def _width(tg: int, moe: MoEConfig) -> int:
    """The expert rows of each (expert, group) of ``tg`` tokens: ``min(C,
    tg)``, since no expert takes more slots than the group has tokens."""
    return min(_capacity(tg, moe), tg)


def expert_rows(tg: int, g: int, moe: MoEConfig) -> int:
    """The expert rows that a dispatch of ``g`` groups of ``tg`` tokens lays
    out and runs every projection over, all experts together."""
    return moe.num_experts * g * _width(tg, moe)


def apply_moe(p: dict, x: torch.Tensor, moe: MoEConfig, activation: str, *,
              per_row: bool = False,
              routing: Optional[SigmoidRouting] = None
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> ``(y (B, S, d), aux)``.

    ``aux`` holds the scaled ``load_balance_loss`` (top-1 fraction times
    mean probability, per expert) and ``router_z_loss`` (mean squared
    logsumexp of the router logits), ``dropped_slots``, the token-slots
    capacity dropped, and ``token_drops`` (B, S), the slots each position
    lost. The tokens form one dispatch (the reference's call on
    a batch); with ``per_row`` each row is a dispatch of its own, with its
    own groups and capacity: what the reference engine's continuation and
    decode programs compute, which route one row at a time under ``vmap``.
    Raises where the group size does not divide the dispatch, as the
    reference asserts. ``routing`` selects the sigmoid router (its bias is
    ``p["router_bias"]``); None, the softmax router.

    Under sharding rules (DTensor operands) the dispatch groups shard over
    the reference's group axes (``"moe_group_dp"``) and the experts over
    ``"expert"``: each rank routes its own groups, runs its own experts on
    them, and the combine's partial sums over the expert axis are reduced
    afterwards (``local_map``), the reference's program for its
    ``(G, E, C, d)`` layout."""
    b, s, d = x.shape
    tokens = s if per_row else b * s
    tg, g = groups_of(b, s, moe, per_row)
    if tokens % tg:
        raise ValueError(f"tokens={tokens} not divisible by group={tg}")
    e = moe.num_experts
    xg = with_sharding(x.reshape(g, tg, d), ("moe_group_dp", None, None))
    weights = (p["router"], p["w_up"], p.get("w_gate"), p["w_down"])
    if not _sharded(xg):
        y, frac, mean_p, z, drops = _dispatch(
            xg, *weights, moe=moe, activation=activation, first=0,
            experts=e, routing=routing, bias=p.get("router_bias"))
    elif routing is not None:
        raise NotImplementedError("the sigmoid router runs unsharded")
    else:
        y, frac, mean_p, z, drops = _sharded_dispatch(
            xg, *weights, moe=moe, activation=activation)
    lb = e * torch.sum(frac * mean_p)
    return y.reshape(b, s, d), {
        "load_balance_loss": lb * moe.aux_loss_coef,
        "router_z_loss": z * moe.router_z_coef,
        "dropped_slots": drops.sum(), "token_drops": drops.reshape(b, s)}


def _sharded(x: torch.Tensor) -> bool:
    if current_mesh_rules() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded_dispatch(xg, router, w_up, w_gate, w_down, *, moe: MoEConfig,
                      activation: str):
    """:func:`_dispatch` on each rank's groups and experts (``local_map``):
    groups as ``xg`` is placed, the router replicated, the experts split
    over ``"expert"`` where it divides them (each rank takes its own
    contiguous run). The combined output is a partial sum over the expert
    axis, the routing statistics means over the group axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, rules = current_mesh_rules()
    names = mesh.mesh_dim_names
    e = moe.num_experts
    expert_axes = resolve_spec(("expert",), (e,), mesh, rules)[0]
    expert_axes = (() if expert_axes is None else (expert_axes,)
                   if isinstance(expert_axes, str) else expert_axes)
    group_dims = [n for n, pl in zip(names, xg.placements)
                  if isinstance(pl, Shard)]
    n_split = 1
    for n in expert_axes:
        n_split *= mesh.size(names.index(n))
    experts = e // n_split
    first = 0
    for n in expert_axes:           # this rank's run of experts
        first = first * mesh.size(names.index(n)) + mesh.get_local_rank(n)
    first *= experts

    def on(axes, inside, outside=Replicate()):
        return tuple(inside if n in axes else outside for n in names)
    groups = tuple(xg.placements)
    weight = on(expert_axes, Shard(0))
    outs = (tuple(Partial() if n in expert_axes else pl
                  for n, pl in zip(names, groups)),       # y
            on(group_dims, Partial("avg")),                # frac
            on(group_dims, Partial("avg")),                # mean_p
            on(group_dims, Partial("avg")),                # z
            groups)                                        # drops
    fn = local_map(
        functools.partial(_dispatch, moe=moe, activation=activation,
                          first=first, experts=experts),
        out_placements=outs,
        in_placements=(groups, on((), None), weight,
                       None if w_gate is None else weight, weight),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(xg, router, w_up, w_gate, w_down)


def _sigmoid_gates(logits: torch.Tensor, bias: torch.Tensor, k: int,
                   routing: SigmoidRouting):
    """Sigmoid scores (G, T, E), and the gates and experts (G, T, k) of the
    top k of the scores plus ``bias`` (ties to the lower index)."""
    scores = torch.sigmoid(logits)
    _, idx = torch.sort(scores + bias.float(), stable=True, dim=-1,
                        descending=True)
    idx = idx[..., :k]
    gates = scores.gather(-1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return scores, gates * routing.routed_scaling_factor, idx


def _dispatch(xg: torch.Tensor, router: torch.Tensor, w_up: torch.Tensor,
              w_gate, w_down: torch.Tensor, *, moe: MoEConfig,
              activation: str, first: int, experts: int,
              routing: Optional[SigmoidRouting] = None,
              bias: Optional[torch.Tensor] = None):
    """The capacity-bounded dispatch of groups ``xg`` (G, T, d) through
    experts ``first .. first + experts - 1`` (the expert weights hold those
    alone): ``(y (G, T, d), top-1 fraction (E,), mean probability (E,),
    z-loss, dropped slots of each token (G, T))``. Slots routed to other experts contribute
    nothing to ``y``."""
    g, tg, d = xg.shape
    e, k = moe.num_experts, moe.top_k
    cap = _capacity(tg, moe)
    width = _width(tg, moe)
    dev = xg.device

    with trace.span("moe.router"):
        if routing is None:
            # router logits in f32 from operands in the activation dtype
            # (the reference's preferred_element_type=f32), then the softmax
            logits = xg.float() @ router.to(xg.dtype).float()
            probs = torch.softmax(logits, -1)                  # (G, T, E)
            # top-k with lax.top_k's tie order (the lower index first): a
            # stable descending sort; the k gates normalised before any drop
            gate_vals, gate_idx = torch.sort(probs, stable=True, dim=-1,
                                             descending=True)
            gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
            gate_vals = gate_vals / torch.clamp(
                gate_vals.sum(-1, keepdim=True), min=1e-9)
        else:
            # the published sigmoid router's logits: its f32 weights over
            # the activations in f32
            logits = xg.float() @ router.float()
            probs, gate_vals, gate_idx = _sigmoid_gates(logits, bias, k,
                                                        routing)
        # slot-major order: (G, k*T), slot j of token t at j*T + t
        expert = gate_idx.transpose(1, 2).reshape(g, k * tg)
        onehot = F.one_hot(expert, e)
        pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)  # place in expert
        keep = pos < cap
        here = keep & (expert >= first) & (expert < first + experts)
        # row of each kept slot in the (experts, G*width) expert rows (pos
        # < min(cap, tg): the capacity decides drops, the width the
        # layout); dropped slots and other ranks' experts point at one
        # spare row past the end, zero in the output
        group = torch.arange(g, device=dev)[:, None]
        row = torch.where(here, ((expert - first) * g + group) * width + pos,
                          experts * g * width)
        token = group * tg + torch.arange(tg, device=dev).repeat(k)[None]
    with trace.span("moe.dispatch"):
        xe = xg.new_zeros(experts * g * width + 1, d)
        xe[row.reshape(-1)] = xg.reshape(-1, d)[token.reshape(-1)]
        xe = xe[:-1].view(experts, g * width, d)
    with trace.span("moe.experts"):
        up = torch.bmm(xe, w_up)
        gate = torch.bmm(xe, w_gate) if w_gate is not None else None
        ye = torch.bmm(activate(up, gate, activation), w_down)
    with trace.span("moe.combine"):
        ye = torch.cat([ye.reshape(-1, d), ye.new_zeros(1, d)])
        # weights cast to the activation dtype (as the reference's combine
        # einsum), products summed in f32
        w = (gate_vals.transpose(1, 2).reshape(g, k * tg) * here).to(
            xg.dtype)
        y = (ye[row].float() * w.float()[..., None]).view(g, k, tg, d)
        y = y.sum(1).to(xg.dtype)

    top1 = F.one_hot(gate_idx[..., 0], e).float()
    z = torch.logsumexp(logits, -1).square().mean()
    return (y, top1.mean((0, 1)), probs.mean((0, 1)), z,
            (~keep).view(g, k, tg).sum(1))
