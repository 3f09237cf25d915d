"""The check can fail: its control (the reference at the next precision
down in the program's place) and planted faults read as not correct, at
smoke widths on the CPU. On the card the same is read at the cells' own
sizes (``bench/run.py --control 1``; ``PERF.md`` gives the readings)."""
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bench_tiny as tiny  # noqa: E402

from bench.harness import cell as cell_mod, serve  # noqa: E402

CPU = torch.device("cpu")
# smoke-width limits, set from these tests' own readings on seeds 11-13:
# the widest gap does not separate the bf16 MoE from its fp8 control
# (program 0.012-0.39, control 0.44-1.18), the mean gap does (program
# 1e-4-2.8e-3, control 0.032-0.078), as at the cells' own sizes; the
# hybrid separates on both (widest 0.013-0.024 against 0.57-1.76, mean
# 1.6e-4-3.9e-4 against 0.046-0.065)
SMOKE_LIMITS = {"moe": {"logit_gap_mean": 0.01},
                "hybrid": {"logit_gap": 0.2, "logit_gap_mean": 0.01}}


def run(c, seed=11, **kw):
    return cell_mod.run(c, seed, 3.0, False, CPU, time.perf_counter(),
                        log=lambda s: None, **kw)


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_control_fails_where_the_program_passes(family):
    c = tiny.cell(family, "burst")
    limits = {**SMOKE_LIMITS[family], "score_gap": 1e-4, "prefix_hits": 0}
    c.config["limits"] = limits
    assert run(c)["result"]["correct"]
    out = run(c, control=True)
    r = out["readings"]
    assert not out["result"]["correct"], out["checks"]
    failed = [k for k in limits if k != "prefix_hits"
              and r[k + "_control"] > limits[k]]
    assert failed == [k for k in limits if k != "prefix_hits"]
    assert all(out["checks"][k]["value"] == r[k + "_control"]
               for k in failed)


def _planted(monkeypatch, plant):
    build = serve.build

    def broken(*a, **kw):
        engine, scorer = build(*a, **kw)
        plant(engine, scorer)
        return engine, scorer
    monkeypatch.setattr(serve, "build", broken)


def test_a_served_token_altered_is_caught(monkeypatch):
    def plant(engine, scorer):
        backend = engine.backend
        sample, calls = backend._sample, []

        def altered(logits):
            out = sample(logits)
            calls.append(1)
            if len(calls) % 5 == 0:   # one row's token every fifth call
                out = out.clone()
                out[0] = (out[0] + 1) % logits.shape[-1]
            return out
        backend._sample = altered
    _planted(monkeypatch, plant)
    out = run(tiny.cell("moe", "batch", dtype="float32"))
    assert not out["result"]["correct"]
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


def test_a_score_altered_is_caught(monkeypatch):
    def plant(engine, scorer):
        score = scorer.predictor.score

        class Off:
            def score(self, prompts):
                s = score(prompts)
                s[0] += 0.5                      # one answer of one call
                return s
        scorer.predictor = Off()
    _planted(monkeypatch, plant)
    out = run(tiny.cell("moe", "batch", dtype="float32"))
    assert not out["result"]["correct"]
    assert out["checks"]["score_gap"]["value"] > \
        out["checks"]["score_gap"]["limit"]


def test_admission_out_of_order_is_caught(monkeypatch):
    def plant(engine, scorer):
        engine.scheduler.policy.key_fn = lambda r: -r.score  # longest first
    _planted(monkeypatch, plant)
    out = run(tiny.cell("moe", "batch", dtype="float32"))
    assert not out["result"]["correct"]
    assert out["checks"]["score_gap"]["value"] > \
        out["checks"]["score_gap"]["limit"]
