"""Iterative re-ranking benchmark: static PARS vs remaining-length SRPT
under the real ServingCore, with a mispredict-robustness sweep.

**Skewed-output trace.** A minority of long responses inside a steady
short/medium stream, preemption on. Static PARS ranks a request by its
predicted *total* length forever: a long request that is 90% decoded still
keys as "long", so every medium arrival preempts it (recompute semantics —
the victim re-prefills prompt *plus* everything it had generated, and that
prefill burst stalls the whole co-resident batch). Iterative re-ranking
refreshes keys to ``max(score − tokens_done, floor)`` on a step cadence:
once a long request's remaining work undercuts the arrivals, it stops being
a victim, finishes, and frees its batch slot. Acceptance bars:

* iterative mean latency >= 1.2x better than static PARS, and
* iterative p99 latency strictly better than static PARS.

**Mispredict-robustness sweep.** Scores carry multiplicative lognormal
noise, ``score = true_len * exp(sigma * N(0, 1))``, one shared noise
realization per sigma so every rank method sees identical predictions.
The sigma axis subsumes the Table-II rank-method comparison: sigma=0 is
the oracle ranker, and each trained method (listwise / pointwise / PARS
pairwise) corresponds to some effective noise level — sweeping sigma
shows how both scheduling modes respond to the *whole* predictor-quality
range rather than three points on it.
Acceptance bar: at the heaviest noise level, iterative degrades no worse
than FCFS (the predictor-free fallback) on mean latency — the
pin-after-K-demotions starvation bound is what keeps noise-churned ranks
from thrashing a request forever.

Everything runs through ``simulate()``, i.e. the same ``ServingCore`` step
loop and ``Scheduler`` the real JAX engine drives — only the backend clock
is virtual.

    PYTHONPATH=src python -m benchmarks.iterative_rank            # full
    PYTHONPATH=src python -m benchmarks.iterative_rank --smoke --json out.json
"""
from __future__ import annotations

import numpy as np

from benchmarks.torch_common import ServingBench, bench_main
from repro_torch.core.scheduler.policies import fcfs, predictor_sjf
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.metrics import RunCounters, report
from repro_torch.serving.simulator import CostModel, simulate

# recompute-heavy regime: preemption is cheap to trigger and expensive to
# pay for, which is exactly where total-length vs remaining-length ranking
# diverges (see module docstring)
COST = CostModel(iter_base_s=0.01, per_seq_s=0.0005,
                 prefill_per_token_s=0.002)
MAX_BATCH = 4
MAX_PREEMPTIONS = 10
RERANK_EVERY_STEPS = 2
PIN_AFTER = 3
NOISE_SIGMAS = (0.0, 0.3, 0.7, 1.2)


def skewed_trace(n: int, *, seed: int = 0, rate_hz: float = 10.0,
                 prompt_words: int = 24):
    """Poisson arrivals; 10% long (240 tok) / 30% medium (48) / 60% short
    (8) outputs. Returns (requests, true_lengths) — scores are attached per
    noise level by :func:`annotate_scores`."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate_hz, n))
    outs = rng.choice([240, 48, 8], size=n, p=[0.10, 0.30, 0.60])
    reqs = []
    for i in range(n):
        prompt = " ".join(f"q{i}w{j}" for j in range(prompt_words))
        reqs.append(Request(i, prompt, float(t[i]), 1 + prompt_words,
                            int(outs[i])))
    return reqs


def noise_factors(n: int, sigma: float, *, seed: int = 7) -> np.ndarray:
    """One lognormal mispredict realization, shared by every rank method at
    a given sigma (fair comparison: same predictions, different use)."""
    if sigma == 0.0:
        return np.ones(n)
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(0.0, sigma, n))


def annotate_scores(reqs, factors) -> None:
    """Pre-annotate noisy predictor scores (``scored`` set, so the policy's
    batched arrival scoring is skipped — the predictor is simulated)."""
    for r, f in zip(reqs, factors):
        r.score = float(r.true_length) * float(f)
        r.scored = True


def _fresh(reqs):
    out = []
    for r in reqs:
        c = Request(r.req_id, r.prompt, r.arrival_time, r.prompt_len,
                    r.true_length)
        c.score, c.scored = r.score, r.scored
        out.append(c)
    return out


def run_method(reqs, method: str) -> dict:
    """One rank method over one (already score-annotated) trace, preemption
    on for every method so the only variable is *how requests are ranked*:

    * ``fcfs``       — arrival order, scores ignored
    * ``static``     — PARS keys frozen at the arrival score
    * ``iterative``  — same scores, refreshed to remaining length on a
      2-step cadence, starvation-bounded by pinning
    """
    reqs = _fresh(reqs)
    policy = fcfs() if method == "fcfs" else predictor_sjf("pars", None)
    # wall-clock starvation boosting is disabled so the comparison isolates
    # the rank methods themselves (boosted requests rank FIFO, which would
    # blur static vs iterative at saturation); the demotion-count pin bound
    # is the starvation mechanism under test for the iterative method
    sched = Scheduler(policy=policy, max_batch=MAX_BATCH, preemption=True,
                      max_preemptions=MAX_PREEMPTIONS,
                      starvation_threshold=float("inf"))
    cfg = (ServingConfig(rerank_every_steps=RERANK_EVERY_STEPS,
                         rerank_pin_after=PIN_AFTER)
           if method == "iterative" else ServingConfig())
    fin = simulate(reqs, sched, cost=COST, config=cfg)
    assert len(fin) == len(reqs), (method, len(fin), len(reqs))
    e2e = np.array([r.finish_time - r.arrival_time for r in fin])
    rep = report(method, fin, counters=RunCounters(
        reranks=sched.rerank_count if cfg.rerank_enabled else None))
    return {
        "mean_latency_s": float(e2e.mean()),
        "p99_latency_s": float(np.percentile(e2e, 99)),
        "avg_per_token_latency_s": rep.avg_per_token_latency,
        "p90_per_token_latency_s": rep.p90_per_token_latency,
        "makespan_s": rep.makespan,
        "preemptions": int(sum(r.preempt_count for r in fin)),
        "pinned": int(sum(1 for r in fin if r.boosted)),
        "reranks": sched.rerank_count if cfg.rerank_enabled else None,
        "rerank_preemptions": (int(sum(r.rerank_preemptions or 0
                                       for r in fin))
                               if cfg.rerank_enabled else None),
    }


def run_sweep(n: int, sigmas=NOISE_SIGMAS) -> dict:
    base = skewed_trace(n)
    out = {"n_requests": n, "sigmas": list(sigmas), "by_sigma": {}}
    print(f"skewed-output trace, n={n}, preemption on "
          f"(max_batch={MAX_BATCH}, max_preemptions={MAX_PREEMPTIONS})")
    print(f"{'sigma':>5s} {'method':>9s} {'mean':>9s} {'p99':>9s} "
          f"{'preempt':>7s} {'pinned':>6s}")
    for sigma in sigmas:
        annotate_scores(base, noise_factors(n, sigma))
        row = {m: run_method(base, m) for m in ("fcfs", "static",
                                                "iterative")}
        out["by_sigma"][f"{sigma:g}"] = row
        for m, r in row.items():
            print(f"{sigma:5.1f} {m:>9s} {r['mean_latency_s']:8.2f}s "
                  f"{r['p99_latency_s']:8.2f}s {r['preemptions']:7d} "
                  f"{r['pinned']:6d}")
    clean = out["by_sigma"][f"{sigmas[0]:g}"]
    heavy = out["by_sigma"][f"{sigmas[-1]:g}"]
    out["mean_speedup_vs_static"] = (clean["static"]["mean_latency_s"]
                                     / clean["iterative"]["mean_latency_s"])
    out["p99_speedup_vs_static"] = (clean["static"]["p99_latency_s"]
                                    / clean["iterative"]["p99_latency_s"])
    out["heavy_noise_vs_fcfs"] = (heavy["iterative"]["mean_latency_s"]
                                  / heavy["fcfs"]["mean_latency_s"])

    # acceptance bars
    assert out["mean_speedup_vs_static"] >= 1.2, \
        f"iterative mean speedup {out['mean_speedup_vs_static']:.2f}x < 1.2x"
    assert clean["iterative"]["p99_latency_s"] \
        < clean["static"]["p99_latency_s"], \
        f"iterative p99 not strictly better ({out['p99_speedup_vs_static']:.2f}x)"
    assert out["heavy_noise_vs_fcfs"] <= 1.0, \
        (f"iterative degrades worse than FCFS at sigma={sigmas[-1]} "
         f"({out['heavy_noise_vs_fcfs']:.2f}x)")
    print(f"  [iterative] mean {out['mean_speedup_vs_static']:.2f}x / "
          f"p99 {out['p99_speedup_vs_static']:.2f}x better than static; "
          f"{out['heavy_noise_vs_fcfs']:.2f}x FCFS at sigma={sigmas[-1]}")
    return out


BENCH = ServingBench(
    name="iterative_rank",
    run=lambda args: run_sweep(args.requests
                               or (220 if args.smoke else 1500)),
    section=lambda r: {
        "mean_speedup_vs_static": r["mean_speedup_vs_static"],
        "p99_speedup_vs_static": r["p99_speedup_vs_static"],
        "heavy_noise_vs_fcfs": r["heavy_noise_vs_fcfs"],
        "by_sigma": r["by_sigma"],
    },
    headline=lambda r: (
        "iterative_rank",
        r["by_sigma"]["0"]["iterative"]["mean_latency_s"] * 1e6,
        f"mean {r['mean_speedup_vs_static']:.2f}x / p99 "
        f"{r['p99_speedup_vs_static']:.2f}x vs static; "
        f"{r['heavy_noise_vs_fcfs']:.2f}x FCFS at heaviest noise"),
    add_args=lambda ap: ap.add_argument(
        "--requests", type=int, default=None, help="override trace length"),
    smoke_help="tiny CI config: prove the sweep runs and all three "
               "acceptance bars hold",
)


def main(argv=None) -> dict:
    return bench_main(BENCH, argv)


if __name__ == "__main__":
    main()
