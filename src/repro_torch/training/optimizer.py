"""Adam / AdamW and utilities, updating the state and the parameters in place.

Port of ``repro/training/optimizer.py``. The API is the reference's optax
triple: ``init(params) -> state``, ``update(grads, state, params) ->
(updates, state)``, ``apply_updates(params, updates)``; parameter trees are
the port's nested dicts of tensors. The arithmetic is the reference's,
operation for operation and in float32: clip on the f32 global norm,
moments in f32, bias correction, then the sum cast back to the parameter's
dtype (no f32 master copy).

The reference builds new trees; here ``mu`` and ``nu`` are updated in place
and ``apply_updates`` writes into the parameter tensors. At full
``llama3_2_3b`` width (3.2 B parameters) the bf16 parameters and gradients
and the f32 moments take 38.5 GB, so a second copy of the moments would not
fit beside them on an 80 GB card. ``update`` still returns a tree of f32
updates, as the reference's does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.bridge import flatten, unflatten

Tree = Dict[str, Any]


class AdamState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclass(frozen=True)
class Adam:
    learning_rate: Any = 1e-3          # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0          # AdamW when > 0
    clip_norm: Optional[float] = None  # global-norm clipping

    def init(self, params: Tree) -> AdamState:
        def zeros():
            return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                              for k, p in flatten(params).items()})
        return AdamState(step=0, mu=zeros(), nu=zeros())

    def _lr(self, step: int) -> float:
        return float(self.learning_rate(step) if callable(self.learning_rate)
                     else self.learning_rate)

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamState,
               params: Optional[Tree] = None) -> Tuple[Tree, AdamState]:
        step = state.step + 1
        scale = None
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        # the scalars in float32, as the reference's traced arithmetic
        sf = _f32(step)
        mhat_c = float(1.0 / (1 - b1 ** sf))
        nhat_c = float(1.0 / (1 - b2 ** sf))
        lr = self._lr(step)
        mu, nu = flatten(state.mu), flatten(state.nu)
        ps = flatten(params) if params is not None else {}
        updates = {}
        for key, g in flatten(grads).items():
            g = g.float()
            if scale is not None:
                g = g * scale
            m, n = mu[key], nu[key]
            m.mul_(b1).add_((1 - b1) * g)
            n.mul_(b2).add_((1 - b2) * torch.square(g))
            u = -lr * (m * mhat_c) / (torch.sqrt(n * nhat_c) + self.eps)
            if self.weight_decay and key in ps:
                u = u - lr * self.weight_decay * ps[key].float()
            updates[key] = u
        return unflatten(updates), AdamState(step=step, mu=state.mu,
                                             nu=state.nu)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p = (f32(p) + u)`` cast back to p's dtype, written into ``params``'
    tensors; returns ``params``."""
    us = flatten(updates)
    for key, p in flatten(params).items():
        p.copy_((p.float() + us[key]).to(p.dtype))
    return params


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves added in the
    reference's order."""
    total = sum(torch.sum(torch.square(leaf.float()))
                for leaf in flatten(tree).values())
    return torch.sqrt(total)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``. ``lr(step)`` is a float32
    scalar tensor on the CPU."""
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr
