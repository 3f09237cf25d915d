"""The paper's own predictor architecture: BERT-base-uncased [paper §III-A].

Not one of the 10 assigned serving architectures — this is the *scheduler's*
model. ``CONFIG`` is the faithful BERT-base size (110M; what you train on real
hardware); ``smoke_config()`` is the container-scale mini used by default in
benchmarks (DESIGN.md §8).
"""
from repro_torch.core.predictor.backbones import PredictorConfig

CONFIG = PredictorConfig(
    backbone="bert",
    vocab_size=30522,        # bert-base-uncased WordPiece
    max_len=128,
    d_model=768,
    num_heads=12,
    num_layers=12,
    d_ff=3072,
)


def smoke_config() -> PredictorConfig:
    return PredictorConfig()     # the repo-wide mini default
