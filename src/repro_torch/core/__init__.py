"""PARS core: pairwise learning-to-rank predictor + predictor-guided scheduler."""
