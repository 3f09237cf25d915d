"""Frozen copy of the synthetic corpus and response-length oracle.

Copied from ``src/repro_torch/data/synthetic.py`` at commit 9acff5f (the
port's copy of the reference's generator, with its CRC-32 seeding of the
hidden lengths), so that later changes to the program cannot move the
benchmark's traffic. Only the generator is kept: ``LLMProfile``,
``MODELS``, the verb and filler tables, ``make_corpus`` and
``sample_lengths``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
# Emulated target LLMs (the paper's three)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LLMProfile:
    name: str
    reasoning: bool
    base: float          # log-length intercept
    slope: float         # complexity sensitivity
    run_sigma: float     # run-to-run lognormal noise (Fig. 2 regime)
    hidden_sigma: float  # per-(prompt,model) latent noise → τ ceiling
    delta: float         # paper's min_length_difference threshold for this LLM


MODELS: Dict[str, LLMProfile] = {
    # instruct-class: short, highly prompt-determined outputs
    "gpt4":  LLMProfile("gpt4",  False, base=2.9, slope=1.00, run_sigma=0.06,
                        hidden_sigma=0.10, delta=0.20),
    "llama": LLMProfile("llama", False, base=2.6, slope=0.90, run_sigma=0.06,
                        hidden_sigma=0.45, delta=0.20),
    # reasoning-class: CoT trace included in length; long + weakly predictable
    "r1":    LLMProfile("r1",    True,  base=6.1, slope=0.75, run_sigma=0.075,
                        hidden_sigma=0.80, delta=0.25),
}

DATASETS = ("alpaca", "lmsys")

# Task verbs with complexity weights (reasoning-heavy verbs → long outputs).
_VERBS = [
    ("what is", -1.2), ("define", -1.0), ("name", -1.3), ("count", -0.8),
    ("translate", -0.5), ("classify", -0.6), ("summarize", 0.1),
    ("list", 0.2), ("describe", 0.4), ("explain", 0.8), ("compare", 0.9),
    ("analyze", 1.1), ("write an essay about", 1.4), ("write code for", 1.2),
    ("prove", 1.6), ("derive", 1.7), ("design a plan for", 1.3),
    ("walk me through", 1.0), ("debate", 1.2), ("brainstorm ideas about", 0.9),
]
_FILLER = ("please could you kindly just quickly briefly the a an of in on "
           "for with about regarding concerning my our this that").split()
N_TOPICS = 240


@dataclass
class Corpus:
    dataset: str
    prompts: List[str]
    z: np.ndarray                      # latent complexity per prompt
    seed: int


def _topic_weights(seed: int = 1234) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1.0, N_TOPICS)


def make_corpus(dataset: str, n: int, seed: int = 0) -> Corpus:
    assert dataset in DATASETS
    rng = np.random.default_rng(seed + (0 if dataset == "alpaca" else 10_000))
    tw = _topic_weights()
    prompts, zs = [], []
    messy = dataset == "lmsys"
    for _ in range(n):
        vi = rng.integers(len(_VERBS))
        ti = rng.integers(N_TOPICS)
        verb, wv = _VERBS[vi]
        n_fill = rng.integers(0, 12 if messy else 5)
        fillers = list(rng.choice(_FILLER, n_fill))
        extra = []
        extra_w = 0.0
        if rng.random() < 0.45:                          # secondary topic
            t2 = rng.integers(N_TOPICS)
            extra = [f"topic{t2}"]
            extra_w = 0.35 * tw[t2]
        words = [verb, f"topic{ti}"] + extra + fillers
        rng.shuffle(words)
        # keep verb first for readability ~half the time
        prompt = verb + " " + " ".join(w for w in words if w != verb)
        z = (1.0 * wv + 0.6 * tw[ti] + extra_w
             + 0.04 * len(prompt.split())
             + rng.normal(0.0, 0.35 if messy else 0.2))  # irreducible
        prompts.append(prompt)
        zs.append(z)
    return Corpus(dataset, prompts, np.asarray(zs, np.float64), seed)


def sample_lengths(corpus: Corpus, model: str, *, run_seed: int = 0,
                   n_runs: int = 1) -> np.ndarray:
    """Ground-truth output lengths. (n,) if n_runs==1 else (n_runs, n).

    The per-(prompt, model) hidden component is drawn from a seed independent
    of ``run_seed`` — repeated runs share it (only run_noise varies), exactly
    like re-querying the same LLM (paper Fig. 2).
    """
    prof = MODELS[model]
    n = len(corpus.prompts)
    # not hash(): Python salts the hash of a str per process, so the seed
    # (and every length) would change from one process to the next
    hidden_rng = np.random.default_rng(
        zlib.crc32(repr((corpus.dataset, corpus.seed, model)).encode()))
    extra = 0.25 if corpus.dataset == "lmsys" else 0.0
    hidden = hidden_rng.normal(0.0, prof.hidden_sigma + extra, n)
    mu = prof.base + prof.slope * corpus.z + hidden
    # reasoning models "overthink" some prompts (heavy right tail, Table I);
    # which prompts is a latent property, stable across runs (paper Fig. 2
    # bounds the *run-to-run* variance to ~25%)
    if prof.reasoning:
        spike = hidden_rng.random(n) < 0.08
        mu = mu + spike * np.log(hidden_rng.integers(2, 5, n))
    run_rng = np.random.default_rng(run_seed + 777)
    noise = run_rng.normal(0.0, prof.run_sigma, (n_runs, n))
    lengths = np.maximum(1, np.round(np.exp(mu[None] + noise))).astype(np.int64)
    return lengths[0] if n_runs == 1 else lengths
