"""Chaos benchmark: the serving stack's fault-tolerance acceptance bars.

Four sections, every one deterministic under its fixed seed (virtual sim
clock, seeded fault schedules, a table-lookup scorer stand-in — no wall
clock, no predictor training):

* **crash_failover** — a 3-replica routed run under scheduled replica
  crashes + cold restarts, against the *same trace* fault-free. Acceptance:
  request conservation across crash/restart (every submitted request is
  finished or terminally dropped, never lost or duplicated), at least one
  failover re-dispatch absorbed, and **bounded p99 TTFT inflation** vs the
  fault-free baseline (crashes cost recompute, not collapse).
* **predictor_degradation** — a scorer outage mid-run on a predictor-SJF
  core. Acceptance: the policy **degrades to FCFS then recovers** (both
  counters advance, and the run ends un-degraded), with every request
  served.
* **deadline_shed** — an overload burst against per-request deadlines and
  the sustained-pressure shedding gate. Acceptance: the overload is resolved
  by *counted terminal drops* (deadline cancels + sheds), and everything
  else finishes.
* **no_fault_parity** — a run with an **empty** ``FaultSchedule`` attached
  must be bit-identical (per-request start / first-token / finish
  timestamps, and per-request routing) to a run with no schedule at all:
  the fault layer's hooks are free when unconfigured.

    PYTHONPATH=src python -m benchmarks.fault_tolerance           # full
    PYTHONPATH=src python -m benchmarks.fault_tolerance --smoke --json out.json
"""
from __future__ import annotations

import numpy as np

from benchmarks.torch_common import ServingBench, bench_main
from repro_torch.core.scheduler.policies import fcfs, predictor_sjf
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.faults import FaultSchedule, ReplicaCrash, ScorerOutage
from repro_torch.serving.simulator import (clone_requests, make_sim_core,
                                     make_sim_replicas, simulate_replicas)
from repro_torch.serving.metrics import RunCounters, report
from repro_torch.serving.router import ReplicaRouter

# Faulty p99 TTFT may cost at most this factor over fault-free. Full-scale
# traces measure ~1.0x (crashes are a small fraction of the run); the smoke
# trace is short enough that two crashes + restarts overlap a large share of
# it, so the bound is sized for that worst case.
P99_INFLATION_BOUND = 8.0


def poisson_trace(n: int, *, rate_hz: float = 6.0, prompt_words: int = 12,
                  short: int = 8, long: int = 64, p_long: float = 0.2,
                  seed: int = 0):
    """Poisson arrivals, bimodal output lengths — the stack's standard
    mixed decode workload, small enough that a smoke run finishes in
    seconds."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / rate_hz, n))
    outs = rng.choice([short, long], size=n, p=[1 - p_long, p_long])
    return [Request(i, " ".join(f"q{i}w{j}" for j in range(prompt_words)),
                    float(t[i]), 1 + prompt_words, int(outs[i]))
            for i in range(n)]


# fresh Request objects so one run's mutations never leak into the next
# (deadlines carry over — they are workload, not run state)
_clone = clone_requests


def _table_scorer(reqs):
    """Perfect-predictor stand-in: score every prompt with its request's
    true output length (no model training in a chaos smoke run)."""
    table = {r.prompt: float(r.true_length) for r in reqs}
    return lambda prompts: [table[p] for p in prompts]


def _assert_conserved(router, trace) -> None:
    retired = sorted(r.req_id for r in
                     [*router.finished, *router.all_dropped])
    assert retired == sorted(r.req_id for r in trace), \
        "request lost or duplicated across crash/restart"


# ----------------------------------------------------------- crash failover
def run_crash_failover(*, n: int = 1200, n_replicas: int = 3) -> dict:
    trace = poisson_trace(n, seed=1)
    kw = dict(n_replicas=n_replicas, policy_factory=fcfs,
              routing="least_kv_pressure", seed=0,
              kv_blocks=96, block_size=16, max_batch=4)

    base = simulate_replicas(_clone(trace), **kw)
    assert len(base.finished) == n
    base_p99 = base.report().routed_ttft_p99_s

    faults = FaultSchedule(crashes=(
        ReplicaCrash(replica=0, at_step=20, down_events=60),
        ReplicaCrash(replica=1, at_step=max(n // 3, 40), down_events=60),
    ))
    faulty = simulate_replicas(_clone(trace), faults=faults,
                               failover_backoff_s=0.05, **kw)
    _assert_conserved(faulty, trace)
    assert faults.injected_crashes >= 2, "scheduled crashes never fired"
    assert faulty.redispatches >= 1, "no failover re-dispatch absorbed"
    rep = faulty.report()
    inflation = rep.routed_ttft_p99_s / max(base_p99, 1e-9)
    assert inflation <= P99_INFLATION_BOUND, \
        f"p99 TTFT inflation {inflation:.2f}x exceeds " \
        f"{P99_INFLATION_BOUND}x under 2 crashes"
    out = {
        "n_requests": n,
        "n_replicas": n_replicas,
        "injected_crashes": faults.injected_crashes,
        "crashes_per_replica": list(rep.crashes),
        "restarts_per_replica": list(rep.restarts),
        "failover_redispatches": rep.failover_redispatches,
        "dropped_total": rep.aggregate.dropped_total,
        "baseline_p99_ttft_s": base_p99,
        "faulty_p99_ttft_s": rep.routed_ttft_p99_s,
        "p99_ttft_inflation": inflation,
        "p99_ttft_inflation_bound": P99_INFLATION_BOUND,
    }
    print(f"  [crash] {faults.injected_crashes} crashes, "
          f"{int(sum(rep.restarts))} restarts, "
          f"{int(rep.failover_redispatches)} redispatches; p99 TTFT "
          f"{rep.routed_ttft_p99_s * 1e3:.1f} ms vs {base_p99 * 1e3:.1f} ms "
          f"fault-free ({inflation:.2f}x <= {P99_INFLATION_BOUND}x)")
    return out


# --------------------------------------------------- predictor degradation
def run_predictor_degradation(*, n: int = 600) -> dict:
    trace = poisson_trace(n, seed=2)
    faults = FaultSchedule(scorer_outages=(
        ScorerOutage(first_call=3, n_calls=4),))
    pol = predictor_sjf("pars", faults.wrap_scorer(_table_scorer(trace)),
                        scorer_failure_budget=2, recovery_probe_every=1)
    core = make_sim_core(Scheduler(policy=pol, max_batch=4),
                         kv_blocks=96, block_size=16)
    faults.attach_core(core)
    core.submit(_clone(trace))
    finished = core.run()
    assert len(finished) + len(core.dropped) == n
    assert faults.injected_scorer_faults >= 4, "scorer outage never fired"
    assert pol.degradations >= 1, "failure budget never degraded the policy"
    assert pol.recoveries >= 1, "the policy never recovered from FCFS"
    assert not pol.degraded, "run ended still degraded"
    rep = report("pars", finished, counters=RunCounters(
        dropped=tuple(core.dropped),
        scorer_failures=pol.scorer_failures,
        degradations=pol.degradations, recoveries=pol.recoveries))
    out = {
        "n_requests": n,
        "scorer_failures": rep.scorer_failures,
        "degradations": rep.predictor_degradations,
        "recoveries": rep.predictor_recoveries,
        "avg_per_token_latency_s": rep.avg_per_token_latency,
        "p99_ttft_s": rep.p99_ttft,
    }
    print(f"  [degrade] {int(rep.scorer_failures)} scorer failures -> "
          f"{int(rep.predictor_degradations)} degradation(s), "
          f"{int(rep.predictor_recoveries)} recovery(ies); all {n} served")
    return out


# ----------------------------------------------------------- deadline/shed
def run_deadline_shed(*, n: int = 400) -> dict:
    # an instantaneous burst: everything arrives at t=0 against a
    # max_batch=2 core, so queue depth stays far above the shed threshold
    trace = poisson_trace(n, rate_hz=1e9, seed=3)
    for r in trace:                 # tight-but-feasible SLO for short work;
        r.deadline = r.arrival_time + (3.0 if r.true_length <= 8 else 1e6)
    core = make_sim_core(Scheduler(policy=fcfs(), max_batch=2),
                         kv_blocks=96, block_size=16,
                         config=ServingConfig(
                             deadline_time_per_token=0.03,
                             shed_queue_depth=max(n // 4, 8),
                             shed_sustain_steps=3))
    core.submit(_clone(trace))
    finished = core.run()
    assert len(finished) + len(core.dropped) == n
    rep = report("fcfs", finished, counters=RunCounters.from_core(core))
    assert rep.dropped_total >= 1, "overload burst produced no drops"
    assert rep.shed >= 1, "sustained overload never shed the tail"
    out = {
        "n_requests": n,
        "finished": len(finished),
        "deadline_cancelled": rep.deadline_cancelled,
        "shed": rep.shed,
        "dropped_total": rep.dropped_total,
    }
    print(f"  [shed] burst of {n}: {len(finished)} finished, "
          f"{int(rep.deadline_cancelled)} deadline-cancelled, "
          f"{int(rep.shed)} shed")
    return out


# --------------------------------------------------------- no-fault parity
def _sig(router) -> list:
    """Bit-level run signature: per-request timing and placement."""
    return sorted((r.req_id, router.assignments[r.req_id], r.start_time,
                   r.first_token_time, r.finish_time)
                  for r in router.finished)


def run_no_fault_parity(*, n: int = 300, n_replicas: int = 2) -> dict:
    trace = poisson_trace(n, seed=4)
    kw = dict(kv_blocks=64, block_size=16, max_batch=4)

    def routed(schedule):
        cores = make_sim_replicas(n_replicas, fcfs, **kw)
        router = ReplicaRouter(cores, policy="round_robin", seed=0)
        if schedule is not None:
            reqs = _clone(trace)
            schedule.skew_arrivals(reqs)
            schedule.attach_router(router)
        else:
            reqs = _clone(trace)
        router.submit(reqs)
        router.run()
        return _sig(router)

    plain, empty = routed(None), routed(FaultSchedule())
    assert plain == empty, \
        "empty FaultSchedule changed behaviour: fault hooks are not free"
    print(f"  [parity] empty schedule bit-identical over {n} requests "
          f"x {n_replicas} replicas")
    return {"n_requests": n, "identical": True}


def _run(args) -> dict:
    print("chaos benchmark" + (" (smoke)" if args.smoke else "") + ":")
    return {
        "crash_failover": run_crash_failover(n=150 if args.smoke else 1200),
        "predictor_degradation":
            run_predictor_degradation(n=120 if args.smoke else 600),
        "deadline_shed": run_deadline_shed(n=80 if args.smoke else 400),
        "no_fault_parity":
            run_no_fault_parity(n=60 if args.smoke else 300),
    }


def _headline(results) -> list:
    cf = results["crash_failover"]
    dg = results["predictor_degradation"]
    return [
        ("fault_crash_failover", cf["faulty_p99_ttft_s"] * 1e6,
         f"p99 TTFT {cf['p99_ttft_inflation']:.2f}x fault-free under "
         f"{cf['injected_crashes']} crashes; conservation held"),
        ("fault_predictor_degradation", dg["p99_ttft_s"] * 1e6,
         f"{int(dg['degradations'])} degradation(s) + "
         f"{int(dg['recoveries'])} recovery(ies) across "
         f"{int(dg['scorer_failures'])} scorer failures"),
    ]


BENCH = ServingBench(
    name="fault_tolerance",
    run=_run,
    section=lambda results: results,
    headline=_headline,
    smoke_help="tiny CI config: prove every acceptance bar holds",
)


def main(argv=None) -> dict:
    return bench_main(BENCH, argv)


if __name__ == "__main__":
    main()
