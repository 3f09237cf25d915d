"""SLO-grade multi-tenant workload harness: the surface PARS is judged on.

Every other benchmark isolates one mechanism (re-ranking, routing, shedding)
on a hand-rolled trace. This harness replays *declarative* multi-tenant
workloads (``repro_torch.serving.workloads``: bursty on/off arrivals, multi-turn
conversations with shared prefixes, reasoning long-tail outputs, priority
classes carrying TTFT/ITL SLOs) through the same ``ServingCore`` /
``ReplicaRouter`` the rest of the repo uses, and scores runs the way
production schedulers are scored — per-class SLO attainment and goodput
(``metrics.slo_report``), not means.

Scenarios (``--scenario``, default all):

* ``multitenant`` — the headline: {fcfs, pars, pars_rerank} on a contended
  bursty trace where an interactive chat tenant (tight TTFT/ITL SLOs)
  competes with a long-output batch tenant. Scores are a noisy oracle
  (``true_length * exp(sigma * N)``, one shared realization — the stand-in
  for a trained predictor, per the mispredict-sweep precedent in
  ``iterative_rank``). Acceptance: pars_rerank's attainment on the
  contended interactive class is *strictly* better than fcfs's.
* ``overload_shed`` — the same class structure under a burst that trips
  sustained-overload shedding. Acceptance: shedding fires, and the
  priority-1 interactive class is shed at a strictly lower rate than the
  priority-0 batch class (class-aware victim selection).
* ``starvation`` — folds the old ``starvation_sweep`` benchmark: the
  starvation-threshold sweep (10 s / 30 s / 120 s / inf) under PARS on an
  overloaded trace, now with SLO attainment alongside max-wait/boost
  counts. Acceptance: a finite threshold strictly bounds the worst-case
  wait vs. threshold = inf.
* ``rate_sweep`` — folds the old ``scheduling_latency`` benchmark (paper
  §IV-D): {fcfs, pars, oracle} across arrival-rate multipliers; the sigma
  axis replaces per-method trained predictors (sigma = 0 is the oracle
  ranker, sigma = 0.3 a PARS-quality one). Acceptance: at the highest
  rate, pars beats fcfs on mean per-token latency.
* ``routed`` — the multitenant trace over 2 replicas: prefix-affinity
  routing vs round-robin, scored by SLO attainment and cross-replica
  conversation-prefix hit rate. Acceptance: affinity's hit rate is at
  least round-robin's.

Every scenario constructs cores exclusively from :class:`ServingConfig`
(no loose core kwargs anywhere) and emits one consolidated
``workload_harness`` section into the repo-root ``BENCH_serving.json``.

    PYTHONPATH=src python -m benchmarks.workload_harness            # full
    PYTHONPATH=src python -m benchmarks.workload_harness --smoke --json o.json
"""
from __future__ import annotations

import numpy as np

from benchmarks.torch_common import ServingBench, bench_main
from repro_torch.core.scheduler.policies import fcfs, predictor_sjf
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.metrics import (RunCounters, SLOReport, report, slo_report)
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.simulator import (CostModel, clone_requests, make_sim_core,
                                     make_sim_replicas)
from repro_torch.serving.workloads import (SLO, ArrivalPhase, ConversationSpec,
                                     OutputDist, PriorityClass, TenantSpec,
                                     WorkloadSpec, generate_trace,
                                     trace_summary)

#: The contended class the headline acceptance bar is measured on.
CONTENDED_CLASS = "interactive"
PARS_SIGMA = 0.3          # noisy-oracle score quality standing in for PARS
MAX_BATCH = 8


def bursty_spec(*, seed: int = 0, duration_s: float = 30.0,
                rate_scale: float = 1.0) -> WorkloadSpec:
    """The harness's reference workload: an interactive chat tenant with
    bursty on/off arrivals, multi-turn conversations and tight SLOs,
    competing with a steady batch tenant whose reasoning long-tail outputs
    are the contention source, plus a smaller agent tenant in between."""
    return WorkloadSpec(tenants=(
        TenantSpec(
            "chat",
            phases=(ArrivalPhase(3.0 * rate_scale, 6.0),
                    ArrivalPhase(0.4 * rate_scale, 6.0)),
            classes=(PriorityClass(CONTENDED_CLASS,
                                   SLO(ttft_s=1.0, itl_s=0.25),
                                   priority=1, weight=3.0),
                     PriorityClass("best_effort", SLO(ttft_s=8.0),
                                   priority=0, weight=1.0)),
            outputs=OutputDist(median_tokens=12, sigma=0.4),
            conversation=ConversationSpec(max_turns=3, p_continue=0.55,
                                          think_time_s=1.0, turn_words=10),
            system_words=48),
        TenantSpec(
            "batch",
            phases=(ArrivalPhase(1.2 * rate_scale, duration_s),),
            classes=(PriorityClass("batch", SLO(), priority=0),),
            outputs=OutputDist(median_tokens=140, sigma=0.7,
                               long_frac=0.10, long_scale=4.0),
            system_words=16),
        TenantSpec(
            "agent",
            phases=(ArrivalPhase(0.8 * rate_scale, 4.0),
                    ArrivalPhase(0.0, 8.0)),
            classes=(PriorityClass("agentic", SLO(ttft_s=2.5),
                                   priority=1, weight=1.0),),
            outputs=OutputDist(median_tokens=60, sigma=0.6,
                               long_frac=0.05, long_scale=4.0),
            conversation=ConversationSpec(max_turns=2, p_continue=0.5,
                                          think_time_s=0.5, turn_words=16),
            system_words=32),
    ), duration_s=duration_s, seed=seed)


def annotate_scores(reqs, sigma: float, *, seed: int = 7) -> None:
    """Noisy-oracle predictor stand-in: ``score = true_length * exp(sigma *
    N(0,1))``, one realization shared by every policy run over the trace
    (fair comparison — same predictions, different use). ``scored`` is set
    so the policy's batched arrival scoring is skipped."""
    rng = np.random.default_rng(seed)
    noise = np.exp(rng.normal(0.0, sigma, len(reqs))) if sigma else \
        np.ones(len(reqs))
    for r, f in zip(reqs, noise):
        r.score = float(r.true_length) * float(f)
        r.scored = True


def _policy(name: str):
    return fcfs() if name == "fcfs" else predictor_sjf("pars", None)


def _core_config(policy_name: str, **extra) -> ServingConfig:
    cfg = ServingConfig(prefix_caching=True, record_token_times=True,
                        **extra)
    if policy_name == "pars_rerank":
        cfg = cfg.replace(rerank_every_steps=4, rerank_pin_after=3)
    return cfg


def _run_one(trace, policy_name: str, *, config: ServingConfig,
             max_batch: int = MAX_BATCH, kv_blocks=None,
             starvation_threshold: float = 120.0,
             cost: CostModel = CostModel()):
    """One policy run over (a fresh clone of) the trace → (core, finished,
    SLOReport, LatencyReport). Preemption is on for every policy (the only
    variable is the rank method), which is where static total-length keys
    and rerank's remaining-length keys diverge."""
    reqs = clone_requests(trace)
    annotate_scores(reqs, 0.0 if policy_name == "oracle" else PARS_SIGMA)
    sched = Scheduler(policy=_policy(policy_name), max_batch=max_batch,
                      preemption=True, max_preemptions=4,
                      starvation_threshold=starvation_threshold)
    core = make_sim_core(sched, cost=cost, kv_blocks=kv_blocks,
                         config=config)
    core.submit(reqs)
    finished = core.run()
    assert len(finished) + len(core.dropped) == len(trace), \
        (policy_name, len(finished), len(core.dropped), len(trace))
    srep = slo_report(policy_name, finished, core.dropped)
    lrep = report(policy_name, finished,
                  counters=RunCounters.from_core(core))
    return core, finished, srep, lrep


def _slo_payload(s: SLOReport) -> dict:
    return {
        "slo_attainment": s.slo_attainment,
        "ttft_attainment": s.ttft_attainment,
        "itl_attainment": s.itl_attainment,
        "goodput_tok_s": s.goodput_tok_s,
        "throughput_tok_s": s.throughput_tok_s,
        "n_dropped": s.n_dropped,
        "per_class": {c.name: {
            "slo_attainment": c.slo_attainment,
            "ttft_attainment": c.ttft_attainment,
            "itl_attainment": c.itl_attainment,
            "goodput_tok_s": c.goodput_tok_s,
            "p99_ttft_s": c.p99_ttft_s,
            "n_requests": c.n_requests,
            "n_dropped": c.n_dropped,
        } for c in s.per_class},
        "per_tenant": {t.name: {
            "p99_ttft_s": t.p99_ttft_s,
            "p99_per_token_latency_s": t.p99_per_token_latency,
            "slo_attainment": t.slo_attainment,
        } for t in s.per_tenant},
    }


# ------------------------------------------------------------- multitenant
def run_multitenant(*, seed: int = 0, duration_s: float = 30.0) -> dict:
    spec = bursty_spec(seed=seed, duration_s=duration_s, rate_scale=1.0)
    trace = generate_trace(spec)
    out = {"trace": trace_summary(trace), "policies": {}}
    print(f"multitenant: {len(trace)} requests over {duration_s:g}s")
    for pol in ("fcfs", "pars", "pars_rerank"):
        _, _, srep, lrep = _run_one(trace, pol, config=_core_config(pol))
        out["policies"][pol] = _slo_payload(srep)
        out["policies"][pol]["avg_per_token_latency_s"] = \
            lrep.avg_per_token_latency
        out["policies"][pol]["prefix_hit_rate"] = lrep.prefix_hit_rate
        print(srep.rows())
    contended = {p: out["policies"][p]["per_class"][CONTENDED_CLASS]
                 for p in out["policies"]}
    out["contended_class"] = CONTENDED_CLASS
    out["contended_attainment"] = {p: c["slo_attainment"]
                                   for p, c in contended.items()}
    out["contended_goodput_gain"] = (
        contended["pars_rerank"]["goodput_tok_s"]
        / max(contended["fcfs"]["goodput_tok_s"], 1e-9))
    # acceptance bar: pars+rerank strictly better attainment than
    # fcfs on the contended class
    assert contended["pars_rerank"]["slo_attainment"] \
        > contended["fcfs"]["slo_attainment"], \
        (f"pars_rerank attainment "
         f"{contended['pars_rerank']['slo_attainment']:.3f} not strictly "
         f"above fcfs {contended['fcfs']['slo_attainment']:.3f} on "
         f"{CONTENDED_CLASS}")
    print(f"  [multitenant] {CONTENDED_CLASS} attainment "
          + " ".join(f"{p}={c['slo_attainment']:.2f}"
                     for p, c in contended.items())
          + f"; goodput gain {out['contended_goodput_gain']:.2f}x")
    return out


# ------------------------------------------------------------ overload_shed
def run_overload_shed(*, seed: int = 0, duration_s: float = 12.0) -> dict:
    # 4x the reference rate against a max_batch=4 core: sustained overload
    spec = bursty_spec(seed=seed, duration_s=duration_s, rate_scale=4.0)
    trace = generate_trace(spec)
    cfg = _core_config("pars", shed_queue_depth=24, shed_sustain_steps=3,
                       shed_predicted_tokens=180.0)
    core, finished, srep, lrep = _run_one(trace, "pars", config=cfg,
                                          max_batch=4)
    shed = [r for r in core.dropped if r.drop_reason == "overload"]
    by_prio = {0: [r for r in trace if r.priority == 0],
               1: [r for r in trace if r.priority == 1]}
    shed_rate = {p: (sum(1 for r in shed if r.priority == p)
                     / max(len(by_prio[p]), 1)) for p in (0, 1)}
    out = {
        "trace": trace_summary(trace),
        "slo": _slo_payload(srep),
        "dropped_total": lrep.dropped_total,
        "shed": lrep.shed,
        "shed_rate_priority0": shed_rate[0],
        "shed_rate_priority1": shed_rate[1],
    }
    assert lrep.shed >= 1, "sustained overload never shed"
    # class-aware victim selection: the priority-1 interactive/agentic
    # classes must survive strictly better than priority-0 work
    assert shed_rate[1] < shed_rate[0], \
        f"priority-1 shed rate {shed_rate[1]:.3f} not below " \
        f"priority-0 {shed_rate[0]:.3f}"
    print(f"  [overload_shed] {int(lrep.shed)} shed of {len(trace)}; "
          f"shed rate p0={shed_rate[0]:.2f} vs p1={shed_rate[1]:.2f}")
    return out


# -------------------------------------------------------------- starvation
def run_starvation(*, seed: int = 0, duration_s: float = 20.0) -> dict:
    """The old ``starvation_sweep`` scenario on a harness trace: PARS under
    overload, threshold sweep, plus SLO attainment per threshold. The
    overload is moderate (2x) on purpose: under extreme overload every
    wait is drain-dominated and the threshold can't move the worst case;
    at 2x the worst case IS the SJF-starved long request, which boosting
    admits earlier."""
    spec = bursty_spec(seed=seed, duration_s=duration_s, rate_scale=2.0)
    trace = generate_trace(spec)
    out = {"trace": trace_summary(trace), "by_threshold": {}}
    print(f"{'threshold':>10s} {'avg ms/tok':>11s} {'max wait s':>11s} "
          f"{'boosted':>8s} {'attain':>7s}")
    for thresh in (5.0, 15.0, 60.0, float("inf")):
        _, fin, srep, lrep = _run_one(trace, "pars",
                                      config=_core_config("pars"),
                                      starvation_threshold=thresh)
        waits = np.array([r.start_time - r.arrival_time for r in fin])
        boosted = int(sum(r.boosted for r in fin))
        label = "inf" if np.isinf(thresh) else f"{thresh:g}s"
        out["by_threshold"][label] = {
            "avg_per_token_latency_s": lrep.avg_per_token_latency,
            "p90_per_token_latency_s": lrep.p90_per_token_latency,
            "max_wait_s": float(waits.max()),
            "boosted": boosted,
            "slo_attainment": srep.slo_attainment,
        }
        print(f"{label:>10s} {lrep.avg_per_token_latency * 1e3:11.1f} "
              f"{waits.max():11.1f} {boosted:8d} "
              f"{srep.slo_attainment:7.2f}")
    tight, free = out["by_threshold"]["5s"], out["by_threshold"]["inf"]
    assert tight["max_wait_s"] < free["max_wait_s"], \
        "finite starvation threshold did not bound worst-case wait"
    assert tight["boosted"] > 0, "overloaded sweep never boosted anyone"
    print(f"  [starvation] 5s threshold bounds max wait "
          f"{tight['max_wait_s']:.1f}s vs {free['max_wait_s']:.1f}s "
          f"unbounded")
    return out


# -------------------------------------------------------------- rate_sweep
def run_rate_sweep(*, seed: int = 0, duration_s: float = 15.0,
                   rates=(0.5, 1.0, 2.0)) -> dict:
    """The old ``scheduling_latency`` §IV-D shape: policies across
    arrival-rate multipliers; sigma-noise oracle scorers stand in for the
    trained predictor ladder (sigma = 0 → oracle, 0.3 → PARS-quality)."""
    out = {"rates": list(rates), "by_rate": {}}
    for rate in rates:
        spec = bursty_spec(seed=seed, duration_s=duration_s,
                           rate_scale=rate)
        trace = generate_trace(spec)
        row = {}
        print(f"# rate x{rate:g}: {len(trace)} requests")
        for pol in ("fcfs", "pars", "oracle"):
            _, _, srep, lrep = _run_one(trace, pol,
                                        config=_core_config(pol))
            row[pol] = {
                "avg_per_token_latency_s": lrep.avg_per_token_latency,
                "p90_per_token_latency_s": lrep.p90_per_token_latency,
                "avg_ttft_s": lrep.avg_ttft,
                "slo_attainment": srep.slo_attainment,
                "goodput_tok_s": srep.goodput_tok_s,
            }
            print("  " + lrep.row())
        out["by_rate"][f"{rate:g}"] = row
    top = out["by_rate"][f"{rates[-1]:g}"]
    out["top_rate_speedup"] = (top["fcfs"]["avg_per_token_latency_s"]
                               / top["pars"]["avg_per_token_latency_s"])
    assert top["pars"]["avg_per_token_latency_s"] \
        < top["fcfs"]["avg_per_token_latency_s"], \
        "pars not below fcfs mean per-token latency at the highest rate"
    print(f"  [rate_sweep] PARS {out['top_rate_speedup']:.2f}x vs FCFS "
          f"at rate x{rates[-1]:g}")
    return out


# ------------------------------------------------------------------ routed
def run_routed(*, seed: int = 0, duration_s: float = 20.0,
               n_replicas: int = 2) -> dict:
    spec = bursty_spec(seed=seed, duration_s=duration_s, rate_scale=1.5)
    trace = generate_trace(spec)
    out = {"trace": trace_summary(trace), "by_routing": {}}
    for routing in ("round_robin", "prefix_affinity"):
        reqs = clone_requests(trace)
        annotate_scores(reqs, PARS_SIGMA)
        cores = make_sim_replicas(
            n_replicas, fcfs, max_batch=4, kv_blocks=128,
            config=ServingConfig(prefix_caching=True,
                                 record_token_times=True))
        router = ReplicaRouter(cores, policy=routing, seed=seed)
        router.submit(reqs)
        router.run()
        rrep = router.report()
        srep = slo_report(routing, router.finished, router.all_dropped)
        out["by_routing"][routing] = {
            "slo": _slo_payload(srep),
            "cross_replica_hit_rate": rrep.cross_replica_hit_rate,
            "load_imbalance": rrep.load_imbalance,
            "routed_ttft_p99_s": rrep.routed_ttft_p99_s,
        }
        print("  " + rrep.row())
    rr = out["by_routing"]["round_robin"]["cross_replica_hit_rate"]
    aff = out["by_routing"]["prefix_affinity"]["cross_replica_hit_rate"]
    assert aff >= rr, \
        f"affinity hit rate {aff:.2f} below round_robin {rr:.2f}"
    print(f"  [routed] conversation-prefix hit rate affinity={aff:.2f} "
          f"vs round_robin={rr:.2f}")
    return out


# ------------------------------------------------------------------ driver
SCENARIOS = {
    "multitenant": run_multitenant,
    "overload_shed": run_overload_shed,
    "starvation": run_starvation,
    "rate_sweep": run_rate_sweep,
    "routed": run_routed,
}
#: Smoke-mode duration scale (full durations already run in seconds on CPU;
#: smoke trims the window, not the structure).
SMOKE_SCALE = 0.6


def _run(args) -> dict:
    scenarios = args.scenario or list(SCENARIOS)
    results = {}
    for name in scenarios:
        print(f"== {name}")
        fn = SCENARIOS[name]
        kw = {"seed": args.seed}
        if args.smoke:
            import inspect
            base = inspect.signature(fn).parameters["duration_s"].default
            kw["duration_s"] = base * SMOKE_SCALE
        results[name] = fn(**kw)
    return results


def _headline(results):
    if "multitenant" not in results:
        return []
    m = results["multitenant"]
    att = m["contended_attainment"]
    return ("workload_harness",
            m["policies"]["pars_rerank"]["per_class"][CONTENDED_CLASS]
             ["p99_ttft_s"] * 1e6,
            f"{CONTENDED_CLASS} attainment fcfs={att['fcfs']:.2f} -> "
            f"pars_rerank={att['pars_rerank']:.2f}; goodput "
            f"{m['contended_goodput_gain']:.2f}x")


def _add_args(ap) -> None:
    ap.add_argument("--scenario", action="append",
                    choices=sorted(SCENARIOS), default=None,
                    help="run a subset (repeatable; default: all)")


BENCH = ServingBench(
    name="workload_harness",
    run=_run,
    section=lambda r: r,
    headline=_headline,
    add_args=_add_args,
    smoke_help="trimmed windows, same structure: prove every scenario's "
               "acceptance bar holds",
)


def main(argv=None) -> dict:
    return bench_main(BENCH, argv)


if __name__ == "__main__":
    main()
