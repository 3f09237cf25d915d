"""Predictor training: pairwise (PARS), pointwise (L1), listwise (ListMLE).

Port of ``repro/core/predictor/train.py``. Protocol follows the paper §IV:
Adam, 5 epochs, batch 128, margin 1.0, δ-filtered pairs for PARS. The paper
fine-tunes pretrained BERT-base at lr 2e-5; the from-scratch backbones here
use lr 3e-4, as the reference's do.

:func:`train_predictor` draws its pairs and permutations from the same numpy
``default_rng`` in the same order as the reference, so both frameworks see
the same batches for the same seed; the step runs eagerly on autograd and
updates the parameters in place (``training.optimizer``).
:class:`RankingPredictor` is the scorer the PARS policy calls; ``save``
writes the reference's checkpoint format and metadata, so the reference's
``RankingPredictor.load`` reads it, and ``load`` reads the reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.bridge import load_npz
from repro_torch.core.predictor.backbones import (PredictorConfig,
                                                  init_predictor,
                                                  predictor_forward)
from repro_torch.core.predictor.losses import (l1_pointwise_loss,
                                               listmle_loss,
                                               margin_ranking_loss)
from repro_torch.core.predictor.metrics import kendall_tau_b
from repro_torch.core.predictor.pairing import build_pairs
from repro_torch.core.predictor.tokenizer import HashTokenizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import Adam, apply_updates
from repro_torch.training.train_loop import value_and_grad

METHODS = ("pairwise", "pointwise", "listwise")


@dataclass
class TrainSettings:
    method: str = "pairwise"
    epochs: int = 5
    batch_size: int = 128
    learning_rate: float = 3e-4
    margin: float = 1.0
    delta: float = 0.20           # min_length_difference threshold (0 = off)
    pairs_per_epoch: int = 6_400
    list_size: int = 16           # listwise group size
    seed: int = 0


@dataclass
class RankingPredictor:
    """Predictor: ``score()`` maps prompts -> expected-length scores.

    Higher score => longer expected response => *lower* SJF priority.
    ``scored`` counts the prompts ``score`` took, ``score_seconds`` its wall
    time (the scores are on the host, so the device's work is in it)."""
    cfg: PredictorConfig
    params: dict
    tokenizer: HashTokenizer
    method: str = "pairwise"
    scored: int = field(default=0, init=False, repr=False, compare=False)
    score_seconds: float = field(default=0.0, init=False, repr=False,
                                 compare=False)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @torch.no_grad()
    def _forward(self, tokens: np.ndarray) -> torch.Tensor:
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)
        return predictor_forward(self.params, self.cfg, toks)

    def score_tokens(self, tokens: np.ndarray) -> np.ndarray:
        return self._forward(tokens).cpu().numpy()

    def score(self, prompts: Sequence[str]) -> np.ndarray:
        t0 = time.perf_counter()
        with trace.span("predictor.score", len(prompts)):
            with trace.span("predictor.tokenize"):
                tokens = self.tokenizer.encode_batch(list(prompts))
            with trace.span("predictor.forward"):
                out = self._forward(tokens)
            with trace.span("predictor.readback"):
                scores = out.cpu().numpy()
        self.scored += len(prompts)
        self.score_seconds += time.perf_counter() - t0
        return scores

    @classmethod
    def init(cls, cfg: PredictorConfig, seed: int = 0, *,
             device: DeviceLike = "cuda") -> "RankingPredictor":
        """An untrained predictor with seeded random parameters."""
        return cls(cfg=cfg, params=init_predictor(cfg, seed, device=device),
                   tokenizer=HashTokenizer(vocab_size=cfg.vocab_size,
                                           max_len=cfg.max_len))

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        """The reference's checkpoint of a predictor: the parameter tree
        and the metadata its ``RankingPredictor.load`` reads."""
        meta = {"method": self.method, "backbone": self.cfg.backbone,
                **{k: getattr(self.cfg, k) for k in
                   ("vocab_size", "max_len", "d_model", "num_heads",
                    "num_layers", "d_ff")}}
        save_checkpoint(path, self.params, metadata=meta)

    @classmethod
    def load(cls, path: str, *,
             device: DeviceLike = "cuda") -> "RankingPredictor":
        """Read a checkpoint written by ``save`` or by the reference's
        ``RankingPredictor.save`` (numpy only, no JAX)."""
        params, meta = load_npz(path, resolve_device(device))
        cfg = PredictorConfig(
            backbone=meta["backbone"], vocab_size=meta["vocab_size"],
            max_len=meta["max_len"], d_model=meta["d_model"],
            num_heads=meta["num_heads"], num_layers=meta["num_layers"],
            d_ff=meta["d_ff"])
        tok = HashTokenizer(vocab_size=cfg.vocab_size, max_len=cfg.max_len)
        return cls(cfg=cfg, params=params, tokenizer=tok,
                   method=meta.get("method", "pairwise"))


def _make_loss(cfg: PredictorConfig, settings: TrainSettings):
    method = settings.method

    if method == "pairwise":
        def loss_fn(params, batch):
            s_a = predictor_forward(params, cfg, batch["tok_a"])
            s_b = predictor_forward(params, cfg, batch["tok_b"])
            return margin_ranking_loss(s_a, s_b, batch["y"], settings.margin)
    elif method == "pointwise":
        def loss_fn(params, batch):
            s = predictor_forward(params, cfg, batch["tokens"])
            return l1_pointwise_loss(s, batch["lengths"])
    elif method == "listwise":
        def loss_fn(params, batch):
            b, l, t = batch["tokens"].shape
            s = predictor_forward(params, cfg,
                                  batch["tokens"].reshape(b * l, t))
            return listmle_loss(s.reshape(b, l),
                                batch["lengths"].reshape(b, l))
    else:
        raise ValueError(f"unknown method {method!r}")
    return loss_fn


def _batches(st: TrainSettings, rng: np.random.Generator,
             tokens: torch.Tensor, lengths: np.ndarray):
    """One epoch's batches, from ``rng`` in the reference's draw order:
    δ-filtered pairs (pairwise), a permutation in batches (pointwise), or a
    permutation in groups of ``list_size`` (listwise)."""
    dev = tokens.device
    n, bs = len(tokens), st.batch_size
    lens = torch.as_tensor(lengths, device=dev)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    if st.method == "pairwise":
        ia, ib, y = build_pairs(lengths, rng, n_pairs=st.pairs_per_epoch,
                                delta=st.delta)
        ia, ib, y = idx(ia), idx(ib), torch.as_tensor(y, device=dev)
        for i in range(0, len(ia) - bs + 1, bs):
            yield {"tok_a": tokens[ia[i:i + bs]],
                   "tok_b": tokens[ib[i:i + bs]], "y": y[i:i + bs]}
    elif st.method == "pointwise":
        perm = idx(rng.permutation(n))
        for i in range(0, n - bs + 1, bs):
            sel = perm[i:i + bs]
            yield {"tokens": tokens[sel], "lengths": lens[sel]}
    else:  # listwise
        ls = st.list_size
        n_lists = max(1, bs // ls)
        perm = rng.permutation(n - n % (ls * n_lists))
        for grp in idx(perm.reshape(-1, n_lists, ls)):
            yield {"tokens": tokens[grp], "lengths": lens[grp]}


def train_predictor(prompts, lengths, *,
                    backbone: str = "bert",
                    settings: Optional[TrainSettings] = None,
                    tokenizer: Optional[HashTokenizer] = None,
                    pcfg: Optional[PredictorConfig] = None,
                    log_fn=None,
                    device: DeviceLike = "cuda") -> RankingPredictor:
    """Train a ranking predictor on (prompt, ground-truth-length) data.

    Each epoch's line to ``log_fn`` gives its mean loss, its step count and
    its milliseconds per step (wall time, ending in a device sync)."""
    st = settings or TrainSettings()
    tok = tokenizer or HashTokenizer()
    cfg = pcfg or PredictorConfig(backbone=backbone, vocab_size=tok.vocab_size,
                                  max_len=tok.max_len)
    dev = resolve_device(device)
    rng = np.random.default_rng(st.seed)
    tokens = torch.as_tensor(tok.encode_batch(list(prompts)),
                             dtype=torch.int64, device=dev)
    lengths = np.asarray(lengths, np.float32)

    params = init_predictor(cfg, st.seed, device=dev)
    opt = Adam(learning_rate=st.learning_rate, clip_norm=1.0)
    opt_state = opt.init(params)
    loss_fn = _make_loss(cfg, st)

    for epoch in range(st.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in _batches(st, rng, tokens, lengths):
            (loss, _), grads = value_and_grad(
                lambda p, b: (loss_fn(p, b), {}), params, batch)
            updates, opt_state = opt.update(grads, opt_state, params)
            apply_updates(params, updates)
            losses.append(loss)
        losses = torch.stack(losses).cpu().numpy() if losses else []
        ms = (time.perf_counter() - t0) * 1e3 / max(len(losses), 1)
        if log_fn:
            log_fn(f"[{st.method}/{backbone}] epoch {epoch}: "
                   f"loss {np.mean(losses):.4f} ({len(losses)} steps, "
                   f"{ms:.2f} ms/step)")

    return RankingPredictor(cfg=cfg, params=params, tokenizer=tok,
                            method=st.method)


def evaluate_tau(predictor: RankingPredictor, prompts, lengths) -> float:
    """Kendall τ_b between predicted scores and ground-truth lengths."""
    scores = predictor.score(prompts)
    return kendall_tau_b(scores, np.asarray(lengths))
