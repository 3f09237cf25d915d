"""The decoder LMs the harness has served from the start: GQA attention in
every layer, alike from the first to the last, with a SwiGLU MLP, sparse
experts (OLMoE) or a Mamba-2 head bank beside attention (Hymba).

Each function looks its target up when it is called, so that a patch of
the target (``bench/trace_window.py`` spans ``weights.make_params``) holds
here too."""
from bench.harness import flops, serve, weights
from bench.reference import lm


def program_config(cfg_json: dict):
    return serve.program_config(cfg_json)


def make_params(cfg, seed: int, device) -> dict:
    return weights.make_params(cfg, seed, device)


def logits(params, model, group, row, own, segments, positions, precision,
           probe=None):
    return lm.logits(params, model, group, row, own, segments, positions,
                     precision, probe)


def tokens_flops(model: dict, positions) -> float:
    return flops.tokens_flops(model, positions)


def decode_bound_s(model: dict, positions, block: int = 0) -> float:
    """Least seconds of one decode step's attention, every layer alike."""
    return flops.decode_bound_s(model, positions, block) \
        * model["num_layers"]
