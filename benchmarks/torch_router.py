"""Multi-replica routing benchmark: policy sweep over the two regimes the
router's metric policies target.

**Affinity trace** (shared-system-prompt families): F prompt families, each
with a long common prefix, interleaved so consecutive arrivals come from
different families. Per-replica KV budgets hold only a couple of family
prefixes, so ``round_robin`` sprays every family across every replica and
churns each LRU, while ``prefix_affinity`` pins each family to the replica
already holding its committed blocks. Acceptance bar: affinity
achieves **>= 2x the aggregate warm hit rate** of round-robin (warm = every
request after its family's first — the cold miss that populates a cache is
excluded in both policies).

**Skewed-output trace** (predictor-aware dispatch): mostly-short responses
with a heavy-tailed long minority, ``Request.score`` pre-annotated with the
true output length (a perfect PARS predictor stand-in — the routing analogue
of the paper's oracle bound). ``round_robin`` keeps assigning to replicas
already stuck behind long decodes; ``predicted_shortest_queue`` dispatches
by predicted remaining work. Acceptance bar: PSQ's **mean routed TTFT is
lower** than round-robin's.

Every policy in ``ROUTING_POLICIES`` runs on both traces (fresh replicas per
run; identical traces per policy). Costs are the simulator's A100-scale
constants; traces are sized to finish in ~1–2 min — ``--requests N`` scales
either trace up (the discrete-event core sweeps ~10^5-request traces in
minutes), ``--smoke`` shrinks both for CI.

    PYTHONPATH=src python -m benchmarks.router                 # full
    PYTHONPATH=src python -m benchmarks.router --smoke --json out.json
"""
from __future__ import annotations

import numpy as np

from benchmarks.torch_common import ServingBench, bench_main
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.request import Request
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.router import ROUTING_POLICIES
from repro_torch.serving.simulator import simulate_replicas


def affinity_trace(n: int = 4000, *, families: int = 8,
                   shared_words: int = 96, unique_words: int = 8,
                   out_len: int = 8, gap_s: float = 0.06,
                   seed: int = 0):
    """Family-interleaved shared-prefix stream (see module docstring)."""
    rng = np.random.default_rng(seed)
    fams = rng.permutation(np.repeat(np.arange(families),
                                     -(-n // families))[:n])
    prompt_len = 1 + shared_words + unique_words        # CLS + words
    reqs = []
    for i, fam in enumerate(fams):
        prompt = (" ".join(f"f{fam}s{k}" for k in range(shared_words))
                  + " " + " ".join(f"u{i}w{j}" for j in range(unique_words)))
        r = Request(i, prompt, i * gap_s, prompt_len, out_len)
        r.score = float(out_len)
        reqs.append(r)
    return reqs


def skew_trace(n: int = 3000, *, prompt_words: int = 16, short: int = 8,
               long: int = 200, p_long: float = 0.15, rate_hz: float = 8.0,
               seed: int = 0):
    """Poisson arrivals, bimodal output lengths, oracle-scored requests."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate_hz, n))
    outs = rng.choice([short, long], size=n, p=[1 - p_long, p_long])
    reqs = []
    for i in range(n):
        prompt = " ".join(f"q{i}w{j}" for j in range(prompt_words))
        r = Request(i, prompt, float(t[i]), 1 + prompt_words, int(outs[i]))
        r.score = float(outs[i])                       # perfect predictor
        reqs.append(r)
    return reqs


def _warm_hit_rate(router, trace) -> float:
    """Hit rate over warm requests only: the first arrival of each prompt
    family is the unavoidable cold miss and is excluded."""
    first_of_family = {}
    for r in sorted(trace, key=lambda r: (r.arrival_time, r.req_id)):
        # all members of a family share the same first prompt word (f"f{fam}s0")
        first_of_family.setdefault(r.prompt.split(" ", 1)[0], r.req_id)
    cold = set(first_of_family.values())
    warm = [r for r in router.finished if r.req_id not in cold]
    hits = [1.0 if (r.cached_prefix_tokens or 0) > 0 else 0.0 for r in warm]
    return float(np.mean(hits)) if hits else float("nan")


def _sweep(trace_fn, *, n_replicas: int, label: str, warm_hits: bool,
           **replica_kw) -> dict:
    out = {}
    print(f"{label} ({n_replicas} replicas):")
    for routing in ROUTING_POLICIES:
        trace = trace_fn()
        router = simulate_replicas(trace, n_replicas=n_replicas,
                                   policy_factory=fcfs, routing=routing,
                                   seed=0, **replica_kw)
        assert len(router.finished) == len(trace)
        rep = router.report()
        out[routing] = {
            "ttft_mean_s": rep.routed_ttft_mean_s,
            "ttft_p99_s": rep.routed_ttft_p99_s,
            "hit_rate": rep.cross_replica_hit_rate,
            "load_imbalance": rep.load_imbalance,
            "requests_per_replica": list(rep.requests_per_replica),
            "throughput_tok_s": rep.aggregate.throughput_tok_s,
        }
        if warm_hits:
            out[routing]["warm_hit_rate"] = _warm_hit_rate(router, trace)
        print("  " + rep.row())
    return out


def run_affinity(*, n: int = 4000, n_replicas: int = 4) -> dict:
    out = _sweep(lambda: affinity_trace(n), n_replicas=n_replicas,
                 label="affinity trace", warm_hits=True,
                 kv_blocks=24, block_size=16, max_batch=4,
                 config=ServingConfig(prefix_caching=True))
    ratio = (out["prefix_affinity"]["warm_hit_rate"]
             / max(out["round_robin"]["warm_hit_rate"], 1e-9))
    out["warm_hit_rate_gain"] = ratio
    # acceptance bar: affinity routing >= 2x round-robin's warm hit rate
    assert out["prefix_affinity"]["warm_hit_rate"] \
        >= 2.0 * out["round_robin"]["warm_hit_rate"], \
        f"affinity warm hit-rate gain {ratio:.2f}x < 2x"
    print(f"  [affinity] warm hit rate {ratio:.1f}x round_robin "
          f"({out['prefix_affinity']['warm_hit_rate']:.2f} vs "
          f"{out['round_robin']['warm_hit_rate']:.2f})")
    return out


def run_skew(*, n: int = 3000, n_replicas: int = 3) -> dict:
    out = _sweep(lambda: skew_trace(n), n_replicas=n_replicas,
                 label="skewed-output trace", warm_hits=False,
                 kv_blocks=64, block_size=16, max_batch=4)
    win = (out["round_robin"]["ttft_mean_s"]
           / out["predicted_shortest_queue"]["ttft_mean_s"])
    out["psq_ttft_speedup"] = win
    # acceptance bar: predictor-aware dispatch lowers mean routed TTFT
    assert out["predicted_shortest_queue"]["ttft_mean_s"] \
        < out["round_robin"]["ttft_mean_s"], \
        f"PSQ mean TTFT not below round_robin ({win:.2f}x)"
    print(f"  [skew] PSQ mean TTFT {win:.2f}x lower than round_robin "
          f"({out['predicted_shortest_queue']['ttft_mean_s'] * 1e3:.1f} ms "
          f"vs {out['round_robin']['ttft_mean_s'] * 1e3:.1f} ms)")
    return out


def _run(args) -> dict:
    results = {}
    if args.mode in ("affinity", "both"):
        results["affinity"] = run_affinity(
            n=args.requests or (240 if args.smoke else 4000))
    if args.mode in ("skew", "both"):
        results["skew"] = run_skew(
            n=args.requests or (240 if args.smoke else 3000))
    return results


def _headline(results) -> list:
    rows = []
    if "affinity" in results:
        a = results["affinity"]
        rows.append(("router_affinity",
                     a["prefix_affinity"]["ttft_mean_s"] * 1e6,
                     f"warm hit rate {a['warm_hit_rate_gain']:.1f}x "
                     f"round_robin "
                     f"({a['prefix_affinity']['warm_hit_rate']:.2f} vs "
                     f"{a['round_robin']['warm_hit_rate']:.2f})"))
    if "skew" in results:
        s = results["skew"]
        rows.append(("router_skew",
                     s["predicted_shortest_queue"]["ttft_mean_s"] * 1e6,
                     f"PSQ mean TTFT {s['psq_ttft_speedup']:.2f}x lower "
                     f"than round_robin"))
    return rows


def _add_args(ap) -> None:
    ap.add_argument("--requests", type=int, default=None,
                    help="override trace length for both regimes")
    ap.add_argument("--mode", choices=("affinity", "skew", "both"),
                    default="both")


BENCH = ServingBench(
    name="router",
    run=_run,
    section=lambda results: {
        k: {
            "warm_hit_rate_gain": v.get("warm_hit_rate_gain"),
            "psq_ttft_speedup": v.get("psq_ttft_speedup"),
            "policies": {p: v[p] for p in ROUTING_POLICIES if p in v},
        } for k, v in results.items()
    },
    headline=_headline,
    add_args=_add_args,
    smoke_help="tiny CI config: prove the sweep runs and both acceptance "
               "bars hold",
)


def main(argv=None) -> dict:
    return bench_main(BENCH, argv)


if __name__ == "__main__":
    main()
