"""Ranking predictor (paper §III-A), inference: backbones, tokenizer, the
``RankingPredictor`` scorer. Training waits for a later slice of the port."""
from repro_torch.core.predictor.backbones import (BACKBONES, PredictorConfig,
                                                  init_predictor,
                                                  predictor_forward)
from repro_torch.core.predictor.tokenizer import HashTokenizer
from repro_torch.core.predictor.train import RankingPredictor
