"""The mini ranking predictor, trained by the benchmark in set-up.

The benchmark trains it itself, from the run's seed, so that neither the
program's trainer nor its initializer makes what the reference reads. The
method is the paper's pairwise one (arXiv:2510.03243, §III-A), in plain
PyTorch: pairs whose lengths differ by at least ``delta`` of the longer
(``build_pairs``, a frozen copy of ``src/repro_torch/core/predictor/
pairing.py`` at commit 9acff5f), the margin ranking loss
``max(0, -y (s_a - s_b) + margin)``, and Adam (b1 0.9, b2 0.999, eps 1e-8)
after clipping the global gradient norm at 1, in float32. The forward is
the reference's (``bench/reference/predictor.py``), its embedding read by
a one-hot product so that training is deterministic: a seed then gives
one predictor, so one ranking and one order of work. The parameter tree
is the program's, so ``RankingPredictor(cfg, params, tokenizer)`` takes
it.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from bench.reference import predictor as ref_predictor
from bench.reference.tokenizer import encode_batch


def build_pairs(lengths: np.ndarray, rng: np.random.Generator, *,
                n_pairs: int, delta: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx_a, idx_b, y), y = +1 where a's length is the longer; pairs
    whose min_length_difference is under ``delta`` are dropped."""
    n = len(lengths)
    ia = rng.integers(0, n, n_pairs * 4)
    ib = rng.integers(0, n, n_pairs * 4)
    la = lengths[ia].astype(np.float64)
    lb = lengths[ib].astype(np.float64)
    diff = np.abs(la - lb) / np.maximum(np.maximum(la, lb), 1.0)
    keep = (ia != ib) & (diff >= delta)
    ia, ib = ia[keep][:n_pairs], ib[keep][:n_pairs]
    y = np.where(lengths[ia] > lengths[ib], 1.0, -1.0).astype(np.float32)
    return ia, ib, y


def init(cfg: dict, gen: torch.Generator, device) -> dict:
    d, f, n = cfg["d_model"], cfg["d_ff"], cfg["num_layers"]

    def normal(*shape, std):
        return torch.empty(shape, device=device).normal_(0.0, std,
                                                         generator=gen)

    def dense(*shape):
        return normal(*shape, std=1.0 / math.sqrt(shape[-2]))

    ones = lambda *s: torch.ones(s, device=device)      # noqa: E731
    zeros = lambda *s: torch.zeros(s, device=device)    # noqa: E731
    return {"embed": normal(cfg["vocab_size"], d, std=0.02),
            "pos": normal(cfg["max_len"], d, std=0.02),
            "layers": {"wq": dense(n, d, d), "wk": dense(n, d, d),
                       "wv": dense(n, d, d), "wo": dense(n, d, d),
                       "w1": dense(n, d, f), "w2": dense(n, f, d),
                       "ln1": ones(n, d), "ln1b": zeros(n, d),
                       "ln2": ones(n, d), "ln2b": zeros(n, d)},
            "ln_f": ones(d), "ln_fb": zeros(d),
            "pooler": dense(d, d), "head": dense(d, 1)}


def _leaves(p: dict):
    for v in p.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def train(cfg: dict, prompts, lengths, seed: int, device, log=None) -> dict:
    """Trained parameters (f32, on ``device``)."""
    st = cfg["train"]
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng([seed, 0x9a15])
    params = init(cfg, gen, device)
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    tokens = torch.as_tensor(encode_batch(prompts, cfg["vocab_size"],
                                          cfg["max_len"]), device=device)
    lengths = np.asarray(lengths)
    bs, lr, b1, b2 = st["batch_size"], st["learning_rate"], 0.9, 0.999
    step = 0
    for epoch in range(st["epochs"]):
        ia, ib, y = build_pairs(lengths, rng, n_pairs=st["pairs_per_epoch"],
                                delta=st["delta"])
        ia, ib = (torch.as_tensor(a, device=device) for a in (ia, ib))
        y = torch.as_tensor(y, device=device)
        losses = []
        for i in range(0, len(ia) - bs + 1, bs):
            s_a = ref_predictor.forward(params, cfg, tokens[ia[i:i + bs]],
                                        onehot=True)
            s_b = ref_predictor.forward(params, cfg, tokens[ib[i:i + bs]],
                                        onehot=True)
            loss = torch.clamp(-y[i:i + bs] * (s_a - s_b) + st["margin"],
                               min=0).mean()
            grads = torch.autograd.grad(loss, leaves)
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            clip = torch.clamp(1.0 / torch.clamp(norm, min=1e-9), max=1.0)
            step += 1
            with torch.no_grad():
                for t, g, m, v in zip(leaves, grads, mu, nu):
                    g = g * clip
                    m.mul_(b1).add_((1 - b1) * g)
                    v.mul_(b2).add_((1 - b2) * g.square())
                    t.add_(-lr * (m / (1 - b1 ** step))
                           / (torch.sqrt(v / (1 - b2 ** step)) + 1e-8))
            losses.append(loss.detach())
        if log:
            log(f"predictor epoch {epoch}: loss "
                f"{torch.stack(losses).mean().item():.4f} "
                f"({len(losses)} steps)")
    for t in leaves:
        t.requires_grad_(False)
    return params
