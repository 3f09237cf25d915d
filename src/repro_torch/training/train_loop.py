"""LM training loop: the train step (loss, autograd, Adam) and a driver.

Port of ``repro/training/train_loop.py``. The step runs eagerly: the loss is
``models.model.lm_loss`` on the plain, differentiable attention (the kernels
have no backward), gradients come from autograd (:func:`value_and_grad`),
and Adam updates its moments and the parameters in place. Gradients are
taken with respect to aliases of the parameters, so the caller's tensors
never require grad and stay usable by the serving path, whose kernels
refuse operands that do.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import lm_loss
from repro_torch.training.optimizer import (Adam, AdamState, apply_updates,
                                            global_norm)

Tree = Dict[str, Any]


def value_and_grad(loss_fn: Callable, params: Tree, batch: Dict):
    """``((loss, aux), grads)`` of ``loss, aux = loss_fn(params, batch)``,
    the gradients a tree like ``params``. They are taken with respect to
    detached aliases of the parameters: the caller's tensors never require
    grad."""
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in flatten(params).items()}
    loss, aux = loss_fn(unflatten(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    aux = {k: v.detach() if torch.is_tensor(v) else v for k, v in aux.items()}
    return (loss.detach(), aux), unflatten(dict(zip(leaves, grads)))


def make_train_step(cfg: ModelConfig, opt: Adam, *, attn_impl: str = "chunked",
                    remat: str = "full", microbatch: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``metrics`` hold ``loss`` and ``grad_norm`` and, with ``microbatch ==
    1``, ``lm_loss``'s metrics: ``ce``, ``load_balance_loss`` and
    ``router_z_loss`` (the MoE family's; zero for the others) and, for
    the MoE family, ``dropped_slots``.

    ``microbatch > 1`` accumulates f32 gradients over that many equal slices
    of the batch and divides by ``microbatch``, as the reference's scan:
    peak activation memory scales with B / microbatch. ``params`` are
    updated in place and returned."""
    def loss_fn(p, mb):
        return lm_loss(p, cfg, mb, attn_impl=attn_impl, remat=remat)

    def train_step(params: Tree, opt_state: AdamState,
                   batch: Dict[str, torch.Tensor]):
        if microbatch == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatch:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"microbatch {microbatch}")
            n = b // microbatch
            acc, loss = None, 0.0
            for i in range(microbatch):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                (l, _), g = value_and_grad(loss_fn, params, mb)
                g = {k: v.float() for k, v in flatten(g).items()}
                acc = g if acc is None else {k: acc[k] + g[k] for k in acc}
                loss = loss + l
            grads = unflatten({k: v / microbatch for k, v in acc.items()})
            loss = loss / microbatch
            metrics = {}
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
        metrics = dict(metrics, loss=loss, grad_norm=global_norm(grads))
        return params, opt_state, metrics
    return train_step


def train(cfg: ModelConfig, params: Tree, batches: Iterable[Dict], *,
          opt: Optional[Adam] = None, steps: int = 100,
          log_every: int = 10, attn_impl: str = "chunked",
          remat: str = "full", log_fn=print) -> Tuple[Tree, list]:
    """CPU- and card-scale driver (examples / smoke). Returns (params,
    history), a record of ``{"loss", "grad_norm", ..., "step", "wall_s"}``
    every ``log_every`` steps and at the last."""
    opt = opt or Adam(learning_rate=3e-4, clip_norm=1.0)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, attn_impl=attn_impl, remat=remat)
    history = []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= steps:
            break
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"], m["wall_s"] = i, time.perf_counter() - t0
            history.append(m)
            log_fn(f"step {i:5d} loss {m['loss']:.4f} "
                   f"gnorm {m['grad_norm']:.3f} ({m['wall_s']:.1f}s)")
    return params, history
