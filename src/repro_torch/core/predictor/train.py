"""The trained ranking predictor as a scorer (inference only).

Port of ``RankingPredictor`` from ``repro/core/predictor/train.py``:
``score()`` maps prompts to expected-length scores for the PARS policy, and
``load()`` reads a checkpoint that the reference's ``RankingPredictor.save``
wrote. Training (losses, optimizer, ``train_predictor``) waits for a later
slice of the port (ROADMAP A8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.bridge import load_npz
from repro_torch.core.predictor.backbones import (PredictorConfig,
                                                  init_predictor,
                                                  predictor_forward)
from repro_torch.core.predictor.tokenizer import HashTokenizer
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class RankingPredictor:
    """Predictor: ``score()`` maps prompts -> expected-length scores.

    Higher score => longer expected response => *lower* SJF priority."""
    cfg: PredictorConfig
    params: dict
    tokenizer: HashTokenizer
    method: str = "pairwise"

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @torch.no_grad()
    def score_tokens(self, tokens: np.ndarray) -> np.ndarray:
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)
        return predictor_forward(self.params, self.cfg, toks).cpu().numpy()

    def score(self, prompts: Sequence[str]) -> np.ndarray:
        return self.score_tokens(self.tokenizer.encode_batch(list(prompts)))

    @classmethod
    def init(cls, cfg: PredictorConfig, seed: int = 0, *,
             device: DeviceLike = "cuda") -> "RankingPredictor":
        """An untrained predictor with seeded random parameters."""
        return cls(cfg=cfg, params=init_predictor(cfg, seed, device=device),
                   tokenizer=HashTokenizer(vocab_size=cfg.vocab_size,
                                           max_len=cfg.max_len))

    @classmethod
    def load(cls, path: str, *,
             device: DeviceLike = "cuda") -> "RankingPredictor":
        """Read a checkpoint written by the reference's
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
