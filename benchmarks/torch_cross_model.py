"""Paper §IV-E: cross-model generalization — predictor trained on the
GPT-4-like generator's lengths, deployed to schedule Llama-like and R1-like
serving (no retraining).

Twin of ``benchmarks/cross_model.py``: the predictors train with the port's
trainer on ``device`` at the ``predictor`` width, and the bursts run
through the port's copy of the simulator (``run_policy``).

    PYTHONPATH=src python -m benchmarks.torch_cross_model \
        [--device cpu] [--predictor pars_bert_base]
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from benchmarks.torch_common import (combo, corpus, emit, get_predictor,
                                     lengths, scale, tau_of)
from repro_torch.core.scheduler.policies import fcfs, make_policy, oracle_sjf
from repro_torch.data.workload import burst_arrivals, make_requests
from repro_torch.device import DeviceLike
from repro_torch.serving.simulator import run_policy

POLICIES = ("fcfs", "cross", "native", "oracle")


def run(*, device: DeviceLike = "cuda", predictor: str = "mini") -> dict:
    sc = scale()
    rng = np.random.default_rng(3)
    results = {}
    t0 = time.perf_counter()
    print("# Cross-model PARS: trained on gpt4 lengths, deployed elsewhere")
    for ds in ("alpaca", "lmsys"):
        xm_pred = get_predictor(ds, "gpt4", method="pairwise", device=device,
                                width=predictor)
        for target in ("llama", "r1"):
            tau_x = tau_of(xm_pred, ds, target)
            native = get_predictor(ds, target, method="pairwise",
                                   device=device, width=predictor)
            tau_n = tau_of(native, ds, target)
            c, L = corpus(ds, "test"), lengths(ds, "test", target)
            idx = rng.integers(0, len(c.prompts), sc.burst)
            mk = lambda: make_requests(c, L, burst_arrivals(sc.burst), indices=idx)
            rep_f = run_policy(mk(), fcfs(), max_batch=16)
            rep_x = run_policy(mk(), make_policy("pars", xm_pred), max_batch=16)
            rep_n = run_policy(mk(), make_policy("pars", native), max_batch=16)
            rep_o = run_policy(mk(), oracle_sjf(), max_batch=16)
            results[(ds, target)] = dict(tau_cross=tau_x, tau_native=tau_n,
                                         fcfs=rep_f, cross=rep_x,
                                         native=rep_n, oracle=rep_o)
            print(f"\n{ds}/{target}: tau cross={tau_x:.3f} native={tau_n:.3f}")
            for tag, rep in (("fcfs", rep_f), ("cross-PARS", rep_x),
                             ("PARS", rep_n), ("oracle", rep_o)):
                print(f"  {tag:11s} {rep.row()}")
            print(f"  => cross-model speedup vs FCFS: "
                  f"{rep_f.avg_per_token_latency / rep_x.avg_per_token_latency:.2f}x")
    us = (time.perf_counter() - t0) * 1e6
    sp = min(r["fcfs"].avg_per_token_latency / r["cross"].avg_per_token_latency
             for r in results.values())
    emit("cross_model", us, f"worst-case cross-model speedup vs FCFS {sp:.1f}x")
    return results


def section(results: dict) -> dict:
    cells = {}
    for (ds, target), r in results.items():
        fcfs_lat = r["fcfs"].avg_per_token_latency
        cells[combo(ds, target)] = {
            "tau_cross": r["tau_cross"], "tau_native": r["tau_native"],
            "avg_per_token_latency": {p: r[p].avg_per_token_latency
                                      for p in POLICIES},
            "p90_per_token_latency": {p: r[p].p90_per_token_latency
                                      for p in POLICIES},
            "speedup_cross_vs_fcfs":
                fcfs_lat / r["cross"].avg_per_token_latency,
            "speedup_native_vs_fcfs":
                fcfs_lat / r["native"].avg_per_token_latency,
            "reports": {p: dataclasses.asdict(r[p]) for p in POLICIES}}
    return {"cells": cells,
            "worst_cross_speedup": min(c["speedup_cross_vs_fcfs"]
                                       for c in cells.values())}


if __name__ == "__main__":
    from benchmarks.torch_run import main
    main(["--only", "cross_model", *sys.argv[1:]])
