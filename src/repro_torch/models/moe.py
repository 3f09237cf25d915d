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
index: each kept slot's token is copied into row ``pos`` of its expert's
``G * C`` rows, one batched product per projection runs every expert over
its rows (rows that no token took stay zero, as the reference's empty
capacity does), and each token sums its kept slots' outputs weighted by
their gates. These are plain large products, outside any kernel in both.

Under ``torch.profiler`` the four stages run in named ranges
(``moe.router``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``), so a
trace with host activity attributes the device time of each stage's
kernels; without a profiler the ranges are not entered.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import activate, dense_init, gated


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig,
             activation: str, dtype: torch.dtype, num_layers: int) -> dict:
    """Stacked expert parameters: an f32 ``router`` (L, d, E) and the
    experts' ``w_up``/``w_gate`` (L, E, d, f) and ``w_down`` (L, E, f, d)."""
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
    return p


def _span(name: str):
    """A named profiler range, entered only while a profiler runs (a
    range costs microseconds of host time even when none does)."""
    return (record_function(name) if torch.autograd._profiler_enabled()
            else contextlib.nullcontext())


def _capacity(group_size: int, moe: MoEConfig) -> int:
    c = int(group_size * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8, min 8


def apply_moe(p: dict, x: torch.Tensor, moe: MoEConfig, activation: str, *,
              per_row: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> ``(y (B, S, d), aux)``.

    ``aux`` holds the scaled ``load_balance_loss`` (top-1 fraction times
    mean probability, per expert) and ``router_z_loss`` (mean squared
    logsumexp of the router logits), and ``dropped_slots``, the token-slots
    capacity dropped. The tokens form one dispatch (the reference's call on
    a batch); with ``per_row`` each row is a dispatch of its own, with its
    own groups and capacity: what the reference engine's continuation and
    decode programs compute, which route one row at a time under ``vmap``.
    Raises where the group size does not divide the dispatch, as the
    reference asserts."""
    b, s, d = x.shape
    tokens = s if per_row else b * s
    tg = min(moe.group_size, tokens)
    if tokens % tg:
        raise ValueError(f"tokens={tokens} not divisible by group={tg}")
    g = b * s // tg
    e, k = moe.num_experts, moe.top_k
    cap = _capacity(tg, moe)
    dev = x.device

    with _span("moe.router"):
        # router logits in f32 from operands in the activation dtype (the
        # reference's preferred_element_type=f32), then the softmax
        logits = (x.reshape(g, tg, d).float()
                  @ p["router"].to(x.dtype).float())
        probs = torch.softmax(logits, -1)                      # (G, T, E)
        # top-k with lax.top_k's tie order (the lower index first): a
        # stable descending sort; the k gates normalised before any drop
        gate_vals, gate_idx = torch.sort(probs, stable=True, dim=-1,
                                         descending=True)
        gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
        # slot-major order: (G, k*T), slot j of token t at j*T + t
        expert = gate_idx.transpose(1, 2).reshape(g, k * tg)
        onehot = F.one_hot(expert, e)
        pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)  # place in expert
        keep = pos < cap
        # row of each kept slot in the (E, G*C) expert rows; dropped slots
        # point at one spare row past the end, zero in the output
        group = torch.arange(g, device=dev)[:, None]
        row = torch.where(keep, (expert * g + group) * cap + pos,
                          e * g * cap)
        token = group * tg + torch.arange(tg, device=dev).repeat(k)[None]
    with _span("moe.dispatch"):
        xe = x.new_zeros(e * g * cap + 1, d)
        xe[row.reshape(-1)] = x.reshape(-1, d)[token.reshape(-1)]
        xe = xe[:-1].view(e, g * cap, d)
    with _span("moe.experts"):
        up = torch.bmm(xe, p["w_up"])
        gate = torch.bmm(xe, p["w_gate"]) if "w_gate" in p else None
        ye = torch.bmm(activate(up, gate, activation), p["w_down"])
    with _span("moe.combine"):
        ye = torch.cat([ye.reshape(-1, d), ye.new_zeros(1, d)])
        # weights cast to the activation dtype (as the reference's combine
        # einsum), products summed in f32
        w = (gate_vals.transpose(1, 2).reshape(g, k * tg) * keep).to(x.dtype)
        y = (ye[row].float() * w.float()[..., None]).view(g, k, tg, d)
        y = y.sum(1).to(x.dtype).reshape(b, s, d)

    top1 = F.one_hot(gate_idx[..., 0], e).float()
    lb = e * torch.sum(top1.mean((0, 1)) * probs.mean((0, 1)))
    z = torch.logsumexp(logits, -1).square().mean()
    return y, {"load_balance_loss": lb * moe.aux_loss_coef,
               "router_z_loss": z * moe.router_z_coef,
               "dropped_slots": (~keep).sum()}
