"""Paper Table III: backbone comparison (T5 / OPT / BERT) under pairwise
training.

Twin of ``benchmarks/table3_backbones.py``: every predictor trains with the
port's trainer on ``device`` at the ``predictor`` width (at
``pars_bert_base`` the backbone field of BERT-base's config is replaced).

    PYTHONPATH=src python -m benchmarks.torch_table3_backbones \
        [--device cpu] [--predictor pars_bert_base]
"""
from __future__ import annotations

import sys
import time

from benchmarks.torch_common import FAST, combo, emit, get_predictor, tau_of
from repro_torch.data.synthetic import DATASETS, MODELS
from repro_torch.device import DeviceLike


def run(*, device: DeviceLike = "cuda", predictor: str = "mini") -> dict:
    combos = ([("alpaca", "gpt4"), ("alpaca", "r1"), ("lmsys", "llama")]
              if FAST else [(d, m) for d in DATASETS for m in MODELS])
    print("# Table III analogue — tau_b by backbone (pairwise training)")
    print(f"{'dataset':8s} {'model':6s} | {'t5':>7s} {'opt':>7s} {'bert':>7s}")
    results = {}
    t0 = time.perf_counter()
    for ds, m in combos:
        row = {}
        for bb in ("t5", "opt", "bert"):
            row[bb] = tau_of(get_predictor(ds, m, backbone=bb, device=device,
                                           width=predictor), ds, m)
        results[(ds, m)] = row
        print(f"{ds:8s} {m:6s} | {row['t5']:7.3f} {row['opt']:7.3f} "
              f"{row['bert']:7.3f}")
    us = (time.perf_counter() - t0) * 1e6
    emit("table3_backbones", us,
         "pairwise effective across all three backbones")
    return results


def section(results: dict) -> dict:
    return {"tau": {combo(*k): row for k, row in results.items()}}


if __name__ == "__main__":
    from benchmarks.torch_run import main
    main(["--only", "table3", *sys.argv[1:]])
