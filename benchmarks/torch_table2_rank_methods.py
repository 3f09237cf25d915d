"""Paper Table II: Kendall τ_b across datasets, LLMs, and ranking approaches
(listwise / pointwise / PARS pairwise).

Twin of ``benchmarks/table2_rank_methods.py``: every predictor trains with
the port's trainer on ``device`` at the ``predictor`` width.

    PYTHONPATH=src python -m benchmarks.torch_table2_rank_methods \
        [--device cpu] [--predictor pars_bert_base]
"""
from __future__ import annotations

import sys
import time

from benchmarks.torch_common import combo, emit, get_predictor, tau_of
from repro_torch.data.synthetic import DATASETS, MODELS
from repro_torch.device import DeviceLike


def run(datasets=DATASETS, models=tuple(MODELS), *,
        device: DeviceLike = "cuda", predictor: str = "mini") -> dict:
    print("# Table II analogue — Kendall tau_b by ranking method")
    print(f"{'dataset':8s} {'model':6s} | {'listwise':>9s} {'pointwise':>9s} "
          f"{'pairwise':>9s}")
    results = {}
    t0 = time.perf_counter()
    for ds in datasets:
        for m in models:
            row = {}
            for method in ("listwise", "pointwise", "pairwise"):
                pred = get_predictor(ds, m, method=method, device=device,
                                     width=predictor)
                row[method] = tau_of(pred, ds, m)
            results[(ds, m)] = row
            print(f"{ds:8s} {m:6s} | {row['listwise']:9.3f} "
                  f"{row['pointwise']:9.3f} {row['pairwise']:9.3f}")
    us = (time.perf_counter() - t0) * 1e6
    wins = sum(1 for r in results.values()
               if r["pairwise"] >= max(r["listwise"], r["pointwise"]) - 0.02)
    emit("table2_rank_methods", us,
         f"pairwise best-or-tied in {wins}/{len(results)} combos")
    return results


def section(results: dict) -> dict:
    wins = sum(1 for r in results.values()
               if r["pairwise"] >= max(r["listwise"], r["pointwise"]) - 0.02)
    return {"tau": {combo(*k): row for k, row in results.items()},
            "pairwise_best_or_tied": wins, "combos": len(results)}


if __name__ == "__main__":
    from benchmarks.torch_run import main
    main(["--only", "table2", *sys.argv[1:]])
