"""Ranking predictor (paper §III-A): backbones, losses, pairing, training."""
from repro_torch.core.predictor.backbones import BACKBONES, PredictorConfig, init_predictor, predictor_forward
from repro_torch.core.predictor.losses import l1_pointwise_loss, listmle_loss, margin_ranking_loss
from repro_torch.core.predictor.metrics import kendall_tau_b
from repro_torch.core.predictor.pairing import DELTA_INSTRUCT, DELTA_REASONING, build_pairs, min_length_difference
from repro_torch.core.predictor.tokenizer import HashTokenizer
from repro_torch.core.predictor.train import (METHODS, RankingPredictor, TrainSettings,
                                              evaluate_tau, train_predictor)
