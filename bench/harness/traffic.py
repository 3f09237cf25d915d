"""The one traffic generator: a mix is a data file of parameters.

A mix (``bench/traffic/<name>.json``) fixes the *sizes* of its requests from
its own ``pool_seed``: every run, whatever its ``--seed``, serves the same
multiset of (prompt tokens, output tokens) at the same arrival times. The
run's seed chooses only which texts carry those sizes and in what order they
arrive within a burst, so two seeds do the same work in another order.

* Output lengths: ``n`` stratified quantiles (``(i + 0.5) / n``) of the
  ``profile``'s lengths over a pool of ``pool_rows`` corpus rows (the frozen
  ``sample_lengths``), clipped at ``max_tokens``.
* Prompt lengths: ``n`` stratified quantiles of a lognormal of the given
  ``median`` and ``sigma``, clipped to ``[1, max]`` tokens, paired with the
  output lengths by a permutation drawn from ``pool_seed``.
* Texts: for each request, an unused pool row whose own length is nearest
  its output length and whose question fits its prompt length; the prompt
  is that question first (the predictor reads only the first 32 tokens),
  then filler context words drawn from the run's seed up to the prompt
  length. The request's ``true_length`` is the size, not the row's length.
* Arrivals: ``"bursts"`` of ``burst_size`` requests at ``t = 0, I, 2I, ...``
  inside the window (``I``, ``burst_interval_s``, from the cell's file), or
  ``"once"``: all ``requests`` due at ``t = 0``.

No two prompts of a run share their first 16 tokens, so the prefix cache
finds no hit in these mixes (a hit would be a fault of the program).
Token counts are the engine's hash tokenizer's: ``[CLS]`` plus one per word.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

from bench.harness import synthetic

BLOCK = 16          # tokens of a prefix-cache block


@dataclass(frozen=True)
class Item:
    """One request as the benchmark makes it."""
    req_id: int
    prompt: str
    arrival: float
    prompt_tokens: int
    output_tokens: int


def _quantiles(values: np.ndarray, n: int) -> np.ndarray:
    s = np.sort(values)
    return s[((np.arange(n) + 0.5) / n * len(s)).astype(np.int64)]


def sizes(mix: dict, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The mix's ``n`` (prompt tokens, output tokens), fixed by its
    ``pool_seed`` alone."""
    pool = _pool(mix)
    out = _quantiles(pool[1], n)
    pt = mix["prompt_tokens"]
    z = np.asarray([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    prompt = np.clip(np.round(pt["median"] * np.exp(pt["sigma"] * z)), 1,
                     pt["max"]).astype(np.int64)
    perm = np.random.default_rng(mix["pool_seed"]).permutation(n)
    return prompt[perm], out


_POOLS: dict = {}


def _pool(mix: dict):
    key = (mix["corpus"], mix["profile"], mix["pool_seed"], mix["pool_rows"],
           mix["max_tokens"])
    if key not in _POOLS:
        corpus = synthetic.make_corpus(mix["corpus"], mix["pool_rows"],
                                       seed=mix["pool_seed"])
        lengths = np.minimum(synthetic.sample_lengths(
            corpus, mix["profile"], run_seed=mix["pool_seed"]),
            mix["max_tokens"])
        _POOLS[key] = (corpus.prompts, lengths)
    return _POOLS[key]


def _question_tokens(q: str) -> int:
    return 1 + len(q.split())


def generate(mix: dict, seed: int, window_s: float,
             interval_s: float = 0.0) -> List[Item]:
    """The requests due inside a window of ``window_s`` seconds."""
    if mix["arrivals"] == "once":
        times = [0.0] * 1
        n = mix["requests"]
    elif mix["arrivals"] == "bursts":
        if interval_s <= 0:
            raise ValueError("a burst mix needs the cell's burst_interval_s")
        times = list(np.arange(0.0, window_s, interval_s))
        n = mix["burst_size"]
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    prompt_toks, out_toks = sizes(mix, n)
    texts, lengths = _pool(mix)
    q_toks = np.asarray([_question_tokens(t) for t in texts])
    rng = np.random.default_rng([seed, 0x7a11])
    used = np.zeros(len(texts), bool)
    vocab = mix["filler_vocab"]
    items: List[Item] = []
    first_blocks = set()
    for t in times:
        order = rng.permutation(n)
        for i in order:
            row = _pick(rng, lengths, used, q_toks, int(out_toks[i]),
                        int(prompt_toks[i]))
            used[row] = True
            prompt = _prompt(rng, texts[row], int(prompt_toks[i]), vocab)
            head = tuple(prompt.split()[:BLOCK - 1])
            while len(head) == BLOCK - 1 and head in first_blocks:
                prompt = _prompt(rng, texts[row], int(prompt_toks[i]), vocab)
                head = tuple(prompt.split()[:BLOCK - 1])
            if len(head) == BLOCK - 1:
                first_blocks.add(head)
            items.append(Item(len(items), prompt, float(t),
                              _question_tokens(prompt), int(out_toks[i])))
    return items


def _pick(rng, lengths, used, q_toks, want_len: int, max_tokens: int) -> int:
    """An unused row whose length is nearest ``want_len`` (a random one
    among equally near rows), preferring questions that fit
    ``max_tokens``."""
    fits = q_toks <= max_tokens
    if not (fits & ~used).any():
        fits = q_toks == q_toks[~used].min()
    dist = np.where(used | ~fits, np.iinfo(np.int64).max,
                    np.abs(lengths - want_len))
    rows = np.flatnonzero(dist == dist.min())
    return int(rows[rng.integers(len(rows))])


def _prompt(rng, question: str, tokens: int, vocab: int) -> str:
    fill = tokens - _question_tokens(question)
    words = [f"ctx{w}" for w in rng.integers(0, vocab, max(fill, 0))]
    return " ".join([question, *words])


def training_set(mix: dict, seed: int, n: int) -> Tuple[List[str], np.ndarray]:
    """``n`` prompts of the mix's form with their output lengths, for the
    predictor: corpus rows of the run's own (never the pool's), prompt
    lengths drawn from the mix's lognormal."""
    corpus_seed = int(np.random.default_rng([seed, 0x7ea1]).integers(2**31))
    corpus = synthetic.make_corpus(mix["corpus"], n, seed=corpus_seed)
    lengths = np.minimum(synthetic.sample_lengths(
        corpus, mix["profile"], run_seed=corpus_seed), mix["max_tokens"])
    rng = np.random.default_rng([seed, 0x7ea2])
    pt = mix["prompt_tokens"]
    want = np.clip(np.round(pt["median"] * np.exp(
        pt["sigma"] * rng.standard_normal(n))), 1, pt["max"]).astype(int)
    prompts = [_prompt(rng, q, int(k), mix["filler_vocab"])
               for q, k in zip(corpus.prompts, want)]
    return prompts, lengths
