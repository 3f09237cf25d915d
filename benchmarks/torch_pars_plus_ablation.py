"""Beyond-paper ablation: PARS+ (prefill-aware SJF) vs PARS.

The paper ranks only by expected decode length. In mixed workloads where a
fraction of requests carry long (RAG/document) prompts, admission pays a
prefill cost ∝ prompt_len that pure PARS ignores. PARS+ adds
α·log1p(prompt_len) to the ranking key (α=0 ≡ PARS).

Workload: alpaca/llama burst with 20% of requests given 100× prompt length
(≈2k prefill tokens at the simulator's 0.5 ms/token prefill cost).

Twin of ``benchmarks/pars_plus_ablation.py``: the predictor trains with the
port's trainer on ``device`` at the ``predictor`` width, and the bursts run
through the port's copy of the simulator.

    PYTHONPATH=src python -m benchmarks.torch_pars_plus_ablation \
        [--device cpu] [--predictor pars_bert_base]
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from benchmarks.torch_common import corpus, emit, get_predictor, lengths, scale
from repro_torch.core.scheduler.policies import fcfs, make_policy, oracle_sjf
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.data.workload import burst_arrivals, make_requests
from repro_torch.device import DeviceLike
from repro_torch.serving.metrics import report
from repro_torch.serving.simulator import simulate


def run(*, device: DeviceLike = "cuda", predictor: str = "mini") -> dict:
    sc = scale()
    rng = np.random.default_rng(11)
    pred = get_predictor("alpaca", "llama", method="pairwise", device=device,
                         width=predictor)
    c, L = corpus("alpaca", "test"), lengths("alpaca", "test", "llama")
    n = sc.burst
    idx = rng.integers(0, len(c.prompts), n)
    base = make_requests(c, L, burst_arrivals(n), indices=idx)
    long_mask = rng.random(n) < 0.2
    for r, is_long in zip(base, long_mask):
        if is_long:
            r.prompt_len *= 100                     # RAG-style document prompt

    print("# PARS+ ablation — 20% long-prompt burst, n =", n)
    results = {}
    t0 = time.perf_counter()
    score_std = float(np.std(pred.score([c.prompts[j] for j in idx[:256]])))
    policies = [("fcfs", fcfs()), ("pars", make_policy("pars", pred))]
    for alpha in (0.25, 0.5, 1.0):
        policies.append((f"pars+a{alpha}", make_policy(
            "pars+", pred, alpha=alpha, score_scale=max(score_std, 1e-6))))
    policies.append(("oracle", oracle_sjf()))
    for name, pol in policies:
        reqs = [type(r)(r.req_id, r.prompt, r.arrival_time, r.prompt_len,
                        r.true_length) for r in base]
        sched = Scheduler(policy=pol, max_batch=16)
        fin = simulate(reqs, sched)
        rep = report(name, fin)
        results[name] = rep
        print("  " + rep.row())
    gain = (results["pars"].avg_per_token_latency
            / min(results[k].avg_per_token_latency
                  for k in results if k.startswith("pars+")))
    print(f"  => best PARS+ vs PARS: {gain:.2f}x")
    emit("pars_plus_ablation", (time.perf_counter() - t0) * 1e6,
         f"prefill-aware ranking gains {gain:.2f}x on long-prompt mix")
    return results


def section(results: dict) -> dict:
    best = min(results[k].avg_per_token_latency
               for k in results if k.startswith("pars+"))
    return {"avg_per_token_latency": {k: r.avg_per_token_latency
                                      for k, r in results.items()},
            "p90_per_token_latency": {k: r.p90_per_token_latency
                                      for k, r in results.items()},
            "best_pars_plus_gain_vs_pars":
                results["pars"].avg_per_token_latency / best,
            "reports": {k: dataclasses.asdict(r) for k, r in results.items()}}


if __name__ == "__main__":
    from benchmarks.torch_run import main
    main(["--only", "pars_plus", *sys.argv[1:]])
