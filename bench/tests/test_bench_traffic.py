"""The traffic mixes: deterministic per seed, the same sizes for every seed,
the stated distributions, and no shared prefix block."""
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.harness import traffic  # noqa: E402

SEED = 2**33 + 12345        # more than 32 bits, as the driver's are


def mix(name):
    with open(ROOT / "bench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def sizes(items):
    return Counter((i.arrival, i.prompt_tokens, i.output_tokens)
                   for i in items)


def test_burst_mix_is_deterministic_and_seed_only_reorders():
    m = mix("lmsys-burst")
    a = traffic.generate(m, SEED, 51, 17)
    b = traffic.generate(m, SEED, 51, 17)
    c = traffic.generate(m, 7, 51, 17)
    assert a == b
    assert [i.prompt for i in a] != [i.prompt for i in c]
    assert sizes(a) == sizes(c)
    assert sorted({i.arrival for i in a}) == [0.0, 17.0, 34.0]
    assert len(a) == 3 * m["burst_size"]
    per_burst = [Counter((i.prompt_tokens, i.output_tokens) for i in a
                         if i.arrival == t) for t in (0.0, 17.0, 34.0)]
    assert per_burst[0] == per_burst[1] == per_burst[2]


def test_batch_mix_distributions():
    m = mix("lmsys-batch")
    items = traffic.generate(m, SEED, 45)
    out = np.asarray([i.output_tokens for i in items])
    prompt = np.asarray([i.prompt_tokens for i in items])
    assert len(items) == m["requests"] and {i.arrival for i in items} == {0}
    # the gpt4 profile over lmsys rows, clipped at 1024
    assert 85 <= out.mean() <= 91 and 43 <= np.median(out) <= 48
    assert 550 <= np.percentile(out, 99) <= 700
    assert out.max() == 1024 and (out == 1024).mean() < 0.005
    # lognormal prompt lengths, median 42, sigma 1: mean about 69
    assert np.median(prompt) == 42 and 66 <= prompt.mean() <= 72
    assert prompt.max() <= 1024
    assert sizes(items) == sizes(traffic.generate(m, 99, 45))


def test_prompt_leads_with_its_question_and_counts_its_tokens():
    m = mix("lmsys-burst")
    for it in traffic.generate(m, SEED, 10, 20):
        words = it.prompt.split()
        assert it.prompt_tokens == 1 + len(words)
        assert not words[0].startswith("ctx")       # the question first
        assert it.output_tokens >= 1


def test_no_two_prompts_share_a_prefix_block():
    m = mix("lmsys-burst")
    items = traffic.generate(m, SEED, 100, 10)
    heads = [tuple(i.prompt.split()[:traffic.BLOCK - 1]) for i in items
             if i.prompt_tokens >= traffic.BLOCK]
    assert len(heads) == len(set(heads))


def test_training_set_is_seeded():
    m = mix("lmsys-burst")
    p1, l1 = traffic.training_set(m, SEED, 50)
    p2, l2 = traffic.training_set(m, SEED, 50)
    p3, _ = traffic.training_set(m, SEED + 1, 50)
    assert p1 == p2 and (l1 == l2).all() and p1 != p3
    assert (l1 >= 1).all() and (l1 <= m["max_tokens"]).all()
