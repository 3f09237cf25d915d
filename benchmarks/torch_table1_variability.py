"""Paper Table I + Fig. 2: output-length spread across model kinds and the
run-to-run relative variance regime the δ-filter is built on.

Twin of ``benchmarks/table1_variability.py`` on the port's data module (no
JAX); it needs only data, so it runs on the host wherever it runs.

    PYTHONPATH=src python -m benchmarks.torch_table1_variability [--device cpu]
"""
from __future__ import annotations

import sys
import time

import numpy as np

from benchmarks.torch_common import emit
from repro_torch.data.synthetic import (EXAMPLE_PROMPTS, MODELS, make_corpus,
                                        sample_lengths)


def run() -> dict:
    t0 = time.perf_counter()
    results = {"lengths": {}, "variance": {}}
    # Table I analogue: fixed low/high-complexity prompts per model kind
    demo = make_corpus("alpaca", 2, seed=0)
    demo.prompts = [EXAMPLE_PROMPTS["Q1"], EXAMPLE_PROMPTS["Q2"]]
    demo.z = np.array([-2.0, 2.6])            # count-like vs prove/derive-like
    print("# Table I analogue — output tokens per (model, prompt)")
    print(f"{'model':8s} {'reasoning':9s} {'Q1 (count)':>12s} {'Q2 (prove)':>12s}")
    for name, prof in MODELS.items():
        L = sample_lengths(demo, name)
        results["lengths"][name] = [int(L[0]), int(L[1])]
        print(f"{name:8s} {str(prof.reasoning):9s} {L[0]:12d} {L[1]:12d}")

    # Fig. 2 analogue: run-to-run relative variance over 30 prompts × 10 runs
    print("\n# Fig. 2 analogue — relative output-length variance, 10 runs")
    c = make_corpus("alpaca", 30, seed=7)
    for name in ("llama", "r1"):
        runs = sample_lengths(c, name, n_runs=10)
        rel = runs.max(0) / runs.min(0) - 1.0
        results["variance"][name] = {
            "median": float(np.median(rel)),
            "p90": float(np.percentile(rel, 90)), "max": float(rel.max())}
        print(f"{name:8s} median {np.median(rel):5.1%}  p90 "
              f"{np.percentile(rel, 90):5.1%}  max {rel.max():5.1%}")
    us = (time.perf_counter() - t0) * 1e6
    emit("table1_variability", us, "lengths+variance regimes reproduced")
    return results


def section(results: dict) -> dict:
    return dict(results)


if __name__ == "__main__":
    from benchmarks.torch_run import main
    main(["--only", "table1", *sys.argv[1:]])
