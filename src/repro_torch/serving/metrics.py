"""Serving metrics: the paper's average & p90 *per-token* latency (§IV) plus
the two latency axes chunked prefill trades between:

* **TTFT** (arrival → first token): chunking a long prompt across steps
  delays *its* first token;
* **inter-token latency** (gap between consecutive output tokens of a
  request already decoding): chunking exists to protect exactly this — an
  unchunked long-prompt burst shows up as a p99 ITL spike on every
  co-resident request.

ITL percentiles come from actual per-token gaps when the run recorded
``Request.token_times`` (``record_token_times=True`` on the core), and fall
back to each request's mean gap (finish − first_token)/(n − 1) otherwise.

Multi-replica runs aggregate through :func:`router_report`: one pooled
``LatencyReport`` over every replica's finished requests plus per-replica
reports and router-level signals (load imbalance, cross-replica
prefix-hit rate, routed TTFT). Aggregation is NaN-safe for replicas that
served zero requests — empty replicas contribute all-NaN per-replica rows
and are excluded from imbalance means; they never poison the pooled
aggregate (which is computed from the pooled request list, not by
averaging per-replica summaries).

Optional run counters (rerank refreshes, dropped requests, scorer faults,
router crash/restart tallies) travel in one :class:`RunCounters` bundle —
``report(..., counters=RunCounters.from_core(core))`` — instead of a
per-feature kwarg each. The historical loose kwargs are still accepted for
one release and produce bit-identical reports (pinned by tests).

SLO-grade workloads (``repro_torch.serving.workloads``) are scored by
:func:`slo_report`: per-priority-class TTFT/ITL SLO attainment, goodput
(= tokens of requests that met every applicable SLO, per second — the
SNIPPETS ch. 9 metric), and per-tenant tail percentiles, all under the same
NaN-when-absent convention (a class without an ITL SLO reports NaN ITL
attainment, never a fake 100%).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler.request import Request, RequestState


@dataclass(frozen=True)
class LatencyReport:
    policy: str
    n_requests: int
    avg_per_token_latency: float      # mean over requests of e2e/outlen
    p90_per_token_latency: float      # 90th percentile of the same
    avg_ttft: float                   # time to first token
    makespan: float                   # last finish − first arrival
    throughput_tok_s: float
    mean_wait: float                  # arrival → admission
    # TTFT tail and decode-gap percentiles (reported separately so prefill
    # policy changes that trade TTFT against inter-token latency are visible)
    p99_ttft: float = float("nan")
    p50_itl: float = float("nan")     # median inter-token gap
    p99_itl: float = float("nan")     # tail inter-token gap (HOL stalls)
    # Prefix caching (NaN when the run had caching disabled — a request only
    # carries ``cached_prefix_tokens`` once the core looked its prefix up)
    prefix_hit_rate: float = float("nan")       # share of requests with a hit
    prefill_tokens_saved: float = float("nan")  # prompt tokens not recomputed
    # Incremental KV reservation (NaN when the run reserved full demand at
    # admission — the counters only exist under kv_reservation="incremental")
    grow_failures: float = float("nan")         # decode-time grow denials
    grow_preemptions: float = float("nan")      # evictions those denials forced
    # Iterative re-ranking (NaN when the run ranked once at arrival — the
    # counters only exist when a rerank cadence was configured)
    reranks: float = float("nan")               # priority-key refreshes
    rerank_preemptions: float = float("nan")    # evictions in refreshed cycles
    # Fault tolerance (NaN when the run had no fault layer — no deadlines,
    # no shedding config, no fault schedule; pass ``dropped`` to ``report``
    # to activate them, even as an empty list → true zeros)
    dropped_total: float = float("nan")         # all terminal non-success exits
    deadline_cancelled: float = float("nan")    # CANCELLED (deadline expiry)
    shed: float = float("nan")                  # SHED (overload shedding)
    rejected: float = float("nan")              # REJECTED (KV-infeasible)
    failed: float = float("nan")                # FAILED (failover budget)
    failovers: float = float("nan")             # crash re-dispatches absorbed
    # Predictor degradation ladder (NaN unless the policy counters are passed)
    scorer_failures: float = float("nan")       # failed scorer dispatches
    predictor_degradations: float = float("nan")  # SJF → FCFS transitions
    predictor_recoveries: float = float("nan")    # FCFS → SJF recoveries

    def row(self) -> str:
        return (f"{self.policy:10s} n={self.n_requests:5d} "
                f"avg={self.avg_per_token_latency * 1e3:9.2f} ms/tok  "
                f"p90={self.p90_per_token_latency * 1e3:9.2f} ms/tok  "
                f"ttft={self.avg_ttft:7.2f} s  "
                f"p99_itl={self.p99_itl * 1e3:8.2f} ms  "
                f"tput={self.throughput_tok_s:9.1f} tok/s")


def _mean(a: np.ndarray) -> float:
    """NaN-safe mean: empty inputs (e.g. a run where no request records
    ``first_token_time``) yield NaN without the numpy empty-slice warning."""
    return float(a.mean()) if len(a) else float("nan")


def _pct(a: np.ndarray, q: float) -> float:
    return float(np.percentile(a, q)) if len(a) else float("nan")


def itl_samples(finished: Sequence[Request]) -> np.ndarray:
    """Inter-token-latency samples pooled across requests.

    Per request: consecutive gaps of ``token_times`` when recorded (the
    first token is TTFT, not ITL, so only gaps *between* output tokens
    count); otherwise the mean gap (finish − first_token)/(n − 1). Requests
    with fewer than two output tokens contribute nothing."""
    samples: List[float] = []
    for r in finished:
        if len(r.token_times) >= 2:
            samples.extend(np.diff(r.token_times))
        elif (r.true_length >= 2 and r.first_token_time is not None
              and r.finish_time is not None):
            samples.append((r.finish_time - r.first_token_time)
                           / (r.true_length - 1))
    return np.asarray(samples, dtype=float)


def _fault_fields(dropped: Optional[Sequence[Request]],
                  scorer_failures: Optional[int],
                  degradations: Optional[int],
                  recoveries: Optional[int]) -> dict:
    """Fault-tolerance counter fields for :class:`LatencyReport`. ``None``
    inputs report NaN (the run had no fault layer); a passed-but-empty
    ``dropped`` reports true zeros — "fault tolerance was on, nothing was
    dropped" is a result, not an absence."""
    out = {}
    if dropped is not None:
        by_reason = {}
        fos = 0.0
        for r in dropped:
            by_reason[r.drop_reason] = by_reason.get(r.drop_reason, 0) + 1
            fos += r.failovers or 0
        out.update(
            dropped_total=float(len(dropped)),
            deadline_cancelled=float(by_reason.get("deadline", 0)),
            shed=float(by_reason.get("overload", 0)),
            rejected=float(by_reason.get("kv-infeasible", 0)),
            failed=float(by_reason.get("failover-budget", 0)),
            failovers=fos,
        )
    if scorer_failures is not None:
        out["scorer_failures"] = float(scorer_failures)
    if degradations is not None:
        out["predictor_degradations"] = float(degradations)
    if recoveries is not None:
        out["predictor_recoveries"] = float(recoveries)
    return out


@dataclass(frozen=True)
class RunCounters:
    """Every optional counter a run can hand the report layer, in one
    bundle. Each field keeps the individual kwargs' convention: ``None``
    means "that layer was not active" and reports NaN; a real zero means
    "active, nothing happened" and reports 0.

    Collect with :meth:`from_core` (single-core runs: rerank cadence from
    the core's config, drops from ``core.dropped``, scorer fault ladder from
    the policy) or :meth:`from_router` (adds per-replica crash/restart
    tallies and failover re-dispatches), or construct directly when a
    benchmark owns its own counting.
    """
    reranks: Optional[float] = None            # priority-key refreshes
    dropped: Optional[Tuple[Request, ...]] = None  # terminal non-success
    scorer_failures: Optional[int] = None      # failed scorer dispatches
    degradations: Optional[int] = None         # SJF → FCFS transitions
    recoveries: Optional[int] = None           # FCFS → SJF recoveries
    # router-level (ignored by single-core ``report``)
    admit_attempts: Tuple[int, ...] = ()
    crashes: Optional[Tuple[int, ...]] = None  # per-replica crash counts
    restarts: Optional[Tuple[int, ...]] = None  # per-replica cold restarts
    redispatches: Optional[int] = None         # failover/escape re-routes

    @classmethod
    def from_core(cls, core) -> "RunCounters":
        """Counters of one ``ServingCore`` run. Reranks are reported iff a
        rerank cadence was configured; drops iff the core has a fault layer
        (deadlines or shedding configured, or anything actually dropped —
        an armed-but-quiet fault layer reports true zeros, not NaN); the
        scorer ladder iff the policy carries degradation state."""
        cfg = core.config
        faulty = (cfg.deadline_time_per_token is not None or cfg.shed_enabled
                  or bool(core.dropped))
        policy = core.scheduler.policy
        laddered = getattr(policy, "degradations", None) is not None
        return cls(
            reranks=core.rerank_count if cfg.rerank_enabled else None,
            dropped=tuple(core.dropped) if faulty else None,
            scorer_failures=(policy.scorer_failures
                             if hasattr(policy, "scorer_failures") and laddered
                             else None),
            degradations=policy.degradations if laddered else None,
            recoveries=policy.recoveries if laddered else None,
        )

    @classmethod
    def from_router(cls, router) -> "RunCounters":
        """Counters of one ``ReplicaRouter`` run (what
        ``ReplicaRouter.report`` always collected inline)."""
        reranked = any(c.config.rerank_enabled for c in router.replicas)
        faulty = bool(any(router.crash_count) or router._restart_at
                      or any(c.dropped for c in router.replicas)
                      or router.dropped)
        return cls(
            reranks=(sum(c.rerank_count for c in router.replicas)
                     if reranked else None),
            dropped=tuple(router.all_dropped) if faulty else None,
            admit_attempts=tuple(router.admit_attempts),
            crashes=tuple(router.crash_count) if faulty else None,
            restarts=tuple(router.restarts) if faulty else None,
            redispatches=router.redispatches if faulty else None,
        )


def _merge_counters(counters: Optional[RunCounters],
                    legacy: dict) -> RunCounters:
    """Resolve the one-release dual API: a :class:`RunCounters` bundle or
    the historical loose kwargs, never both."""
    passed = {k: v for k, v in legacy.items()
              if (v is not None and v != ()) }
    if counters is not None:
        if passed:
            raise TypeError(f"pass either counters=RunCounters(...) or "
                            f"legacy counter keywords, not both "
                            f"(got counters= and {sorted(passed)})")
        return counters
    if legacy.get("dropped") is not None:
        legacy["dropped"] = tuple(legacy["dropped"])
    return RunCounters(**legacy)


def report(policy: str, finished: Sequence[Request], *,
           counters: Optional[RunCounters] = None,
           reranks: Optional[float] = None,
           dropped: Optional[Sequence[Request]] = None,
           scorer_failures: Optional[int] = None,
           degradations: Optional[int] = None,
           recoveries: Optional[int] = None) -> LatencyReport:
    """``counters`` — a :class:`RunCounters` bundle holding every optional
    run counter (the blessed form; ``RunCounters.from_core(core)`` collects
    it). The loose keywords are the deprecated one-release equivalents and
    are mutually exclusive with ``counters``:

    ``reranks`` — core-level count of priority-key refreshes for the run
    that produced ``finished`` (``ServingCore.rerank_count``); ``None``
    (default) reports NaN, the "run never re-ranked" convention.
    ``dropped`` — terminally dropped requests (cancelled / shed / rejected /
    failed); latency stats are computed over ``finished`` only (a dropped
    request has no completion latency), the drop counters over ``dropped``.
    The scorer/degradation counters come from the policy's fault ladder
    (``Policy.scorer_failures`` etc.); ``None`` = no fault layer = NaN."""
    c = _merge_counters(counters, dict(
        reranks=reranks, dropped=dropped, scorer_failures=scorer_failures,
        degradations=degradations, recoveries=recoveries))
    reranks, dropped = c.reranks, c.dropped
    faults = _fault_fields(dropped, c.scorer_failures, c.degradations,
                           c.recoveries)
    if not finished:
        # every latency field NaN, including makespan/throughput: a replica
        # that served nothing has no makespan, and a literal 0.0 would skew
        # cross-replica min/mean comparisons the router report makes
        # (NaN means "absent" everywhere else in this report)
        return LatencyReport(policy=policy, n_requests=0,
                             avg_per_token_latency=float("nan"),
                             p90_per_token_latency=float("nan"),
                             avg_ttft=float("nan"), makespan=float("nan"),
                             throughput_tok_s=float("nan"),
                             mean_wait=float("nan"), **faults)
    per_tok = np.array([r.per_token_latency() for r in finished])
    ttft = np.array([(r.first_token_time - r.arrival_time) for r in finished
                     if r.first_token_time is not None])
    waits = np.array([(r.start_time - r.arrival_time) for r in finished
                      if r.start_time is not None])
    itl = itl_samples(finished)
    t0 = min(r.arrival_time for r in finished)
    t1 = max(r.finish_time for r in finished)
    tokens = sum(r.true_length for r in finished)
    cached = np.asarray([r.cached_prefix_tokens for r in finished
                         if r.cached_prefix_tokens is not None], dtype=float)
    growf = np.asarray([r.grow_failures for r in finished
                        if r.grow_failures is not None], dtype=float)
    growp = np.asarray([r.grow_preemptions for r in finished
                        if r.grow_preemptions is not None], dtype=float)
    rrank = np.asarray([r.rerank_preemptions for r in finished
                        if r.rerank_preemptions is not None], dtype=float)
    return LatencyReport(
        policy=policy,
        n_requests=len(finished),
        avg_per_token_latency=_mean(per_tok),
        p90_per_token_latency=float(np.percentile(per_tok, 90)),
        avg_ttft=_mean(ttft),
        makespan=float(t1 - t0),
        throughput_tok_s=float(tokens / max(t1 - t0, 1e-9)),
        mean_wait=_mean(waits),
        p99_ttft=_pct(ttft, 99),
        p50_itl=_pct(itl, 50),
        p99_itl=_pct(itl, 99),
        prefix_hit_rate=_mean(cached > 0),
        prefill_tokens_saved=float(cached.sum()) if len(cached)
        else float("nan"),
        grow_failures=float(growf.sum()) if len(growf) else float("nan"),
        grow_preemptions=float(growp.sum()) if len(growp) else float("nan"),
        reranks=float(reranks) if reranks is not None else float("nan"),
        rerank_preemptions=float(rrank.sum()) if len(rrank)
        else float("nan"),
        **faults,
    )


# --------------------------------------------------------------- multi-replica
@dataclass(frozen=True)
class RouterReport:
    """Aggregate + per-replica view of one multi-replica routed run.

    ``aggregate`` is a :class:`LatencyReport` over the *pooled* finished
    requests of every replica (so its means/percentiles are request-weighted,
    never averages of per-replica summaries — an empty replica cannot poison
    them with NaN). ``per_replica[i]`` is replica *i*'s own report; replicas
    that served nothing report all-NaN rows, by the same "NaN means absent"
    convention the latency report uses.
    """
    policy: str                            # routing policy name
    n_replicas: int
    n_requests: int                        # pooled finished count
    aggregate: LatencyReport
    per_replica: Tuple[LatencyReport, ...]
    requests_per_replica: Tuple[int, ...]
    tokens_per_replica: Tuple[int, ...]    # generated tokens per replica
    # max/mean served requests per *serving* replica (1.0 = perfectly even;
    # NaN when nothing finished anywhere). Replicas that served zero requests
    # still count in the mean — an idle replica IS imbalance.
    load_imbalance: float
    token_imbalance: float                 # same ratio over generated tokens
    # Prefix-cache affinity signal: pooled hit rate across replicas (NaN when
    # caching was off everywhere) — the number cache-affinity routing moves.
    cross_replica_hit_rate: float
    routed_ttft_mean_s: float              # arrival → first token, pooled
    routed_ttft_p99_s: float
    # Router-level admission-gate traffic per replica (attempts include
    # KV-gate deferrals re-tried on later cycles); () when the run did not
    # go through a router that counts them.
    admit_attempts: Tuple[int, ...] = ()
    # Fault tolerance (empty tuples / NaN when the run had no fault layer):
    # per-replica crash and cold-restart counts, and router-level failover /
    # escape re-dispatches. The pooled drop counters live on ``aggregate``.
    crashes: Tuple[int, ...] = ()
    restarts: Tuple[int, ...] = ()
    failover_redispatches: float = float("nan")

    def row(self) -> str:
        return (f"{self.policy:24s} n={self.n_requests:6d} "
                f"ttft={self.routed_ttft_mean_s * 1e3:9.2f} ms  "
                f"hit_rate={self.cross_replica_hit_rate:5.2f}  "
                f"imbalance={self.load_imbalance:5.2f}  "
                f"per_replica={list(self.requests_per_replica)}")


def _imbalance(counts: Sequence[int]) -> float:
    """max/mean of per-replica counts; NaN when every replica is empty (no
    load to be imbalanced about — 0/0 must not warn or crash)."""
    total = sum(counts)
    if not counts or total == 0:
        return float("nan")
    return max(counts) / (total / len(counts))


def router_report(policy: str,
                  per_replica_finished: Sequence[Sequence[Request]],
                  admit_attempts: Sequence[int] = (),
                  counters: Optional[RunCounters] = None,
                  reranks: Optional[float] = None,
                  dropped: Optional[Sequence[Request]] = None,
                  crashes: Optional[Sequence[int]] = None,
                  restarts: Optional[Sequence[int]] = None,
                  redispatches: Optional[int] = None) -> RouterReport:
    """NaN-safe aggregation of N replicas' finished requests (any of which
    may be empty) into one :class:`RouterReport`. ``counters`` — one
    :class:`RunCounters` bundle (``RunCounters.from_router(router)``
    collects it, ``admit_attempts`` included); the loose keywords are the
    deprecated one-release equivalents, mutually exclusive with it.
    ``reranks`` — total priority-key refreshes across replicas, ``None``
    when no replica re-ranked (reported NaN, like every other absent
    counter). The fault parameters (``dropped`` / ``crashes`` /
    ``restarts`` / ``redispatches``) follow the same convention: ``None`` =
    no fault layer = NaN/empty."""
    c = _merge_counters(counters, dict(
        reranks=reranks, dropped=dropped,
        admit_attempts=tuple(admit_attempts),
        crashes=tuple(crashes) if crashes is not None else None,
        restarts=tuple(restarts) if restarts is not None else None,
        redispatches=redispatches))
    pooled = [r for fin in per_replica_finished for r in fin]
    agg = report(policy, pooled,
                 counters=RunCounters(reranks=c.reranks, dropped=c.dropped))
    per = tuple(report(f"{policy}/r{i}", fin)
                for i, fin in enumerate(per_replica_finished))
    counts = tuple(len(fin) for fin in per_replica_finished)
    tokens = tuple(sum(r.true_length for r in fin)
                   for fin in per_replica_finished)
    return RouterReport(
        policy=policy,
        n_replicas=len(per_replica_finished),
        n_requests=len(pooled),
        aggregate=agg,
        per_replica=per,
        requests_per_replica=counts,
        tokens_per_replica=tokens,
        load_imbalance=_imbalance(counts),
        token_imbalance=_imbalance(tokens),
        cross_replica_hit_rate=agg.prefix_hit_rate,
        routed_ttft_mean_s=agg.avg_ttft,
        routed_ttft_p99_s=agg.p99_ttft,
        admit_attempts=tuple(c.admit_attempts),
        crashes=c.crashes if c.crashes is not None else (),
        restarts=c.restarts if c.restarts is not None else (),
        failover_redispatches=(float(c.redispatches)
                               if c.redispatches is not None
                               else float("nan")),
    )


# ------------------------------------------------------------------ SLO layer
def meets_ttft(r: Request) -> Optional[bool]:
    """Did ``r`` meet its TTFT SLO? ``None`` when it carries none (not
    applicable — never counted in attainment). A request that never produced
    a first token (dropped before decode) missed by definition."""
    if r.slo_ttft_s is None:
        return None
    if r.first_token_time is None:
        return False
    return (r.first_token_time - r.arrival_time) <= r.slo_ttft_s


def meets_itl(r: Request) -> Optional[bool]:
    """Did ``r`` meet its inter-token-latency SLO (mean gap between output
    tokens ≤ ``slo_itl_s``)? Gaps come from ``token_times`` when the run
    recorded them, else the (finish − first)/(n − 1) mean. ``None`` when the
    request carries no ITL SLO; a request with fewer than two output tokens
    has no inter-token gap and trivially meets; a dropped request missed."""
    if r.slo_itl_s is None:
        return None
    if r.state is not RequestState.FINISHED:
        return False
    if r.true_length < 2:
        return True
    if len(r.token_times) >= 2:
        mean_gap = float(np.mean(np.diff(r.token_times)))
    elif r.first_token_time is not None and r.finish_time is not None:
        mean_gap = (r.finish_time - r.first_token_time) / (r.true_length - 1)
    else:
        return False
    return mean_gap <= r.slo_itl_s


def meets_slo(r: Request) -> Optional[bool]:
    """Every *applicable* SLO met. ``None`` when the request carries no SLO
    at all — such requests are excluded from attainment rates but count
    toward goodput (nothing to violate)."""
    checks = [m for m in (meets_ttft(r), meets_itl(r)) if m is not None]
    if not checks:
        return None
    return all(checks)


def _attainment(flags: List[Optional[bool]]) -> float:
    """Share of applicable (non-``None``) flags that are True; NaN when no
    request in the group carried that SLO."""
    applicable = [f for f in flags if f is not None]
    return _mean(np.asarray(applicable, dtype=float)) if applicable \
        else float("nan")


@dataclass(frozen=True)
class ClassSLOStats:
    """One priority class's SLO scorecard (requests pooled across tenants)."""
    name: str
    priority: int
    n_requests: int                   # finished + dropped
    n_finished: int
    n_dropped: int
    ttft_attainment: float            # share meeting TTFT SLO (NaN: no SLO)
    itl_attainment: float             # share meeting ITL SLO (NaN: no SLO)
    slo_attainment: float             # share meeting every applicable SLO
    goodput_tok_s: float              # SLO-met output tokens / makespan
    throughput_tok_s: float           # all finished output tokens / makespan
    avg_ttft_s: float
    p99_ttft_s: float
    p99_itl_s: float

    def row(self) -> str:
        return (f"  {self.name:14s} n={self.n_requests:5d} "
                f"attain={self.slo_attainment:5.2f} "
                f"(ttft={self.ttft_attainment:5.2f} "
                f"itl={self.itl_attainment:5.2f})  "
                f"goodput={self.goodput_tok_s:8.1f} tok/s  "
                f"p99_ttft={self.p99_ttft_s:7.2f} s")


@dataclass(frozen=True)
class TenantStats:
    """One tenant's tail-latency row (finished requests only)."""
    name: str
    n_requests: int
    p50_ttft_s: float
    p99_ttft_s: float
    p99_per_token_latency: float
    slo_attainment: float


@dataclass(frozen=True)
class SLOReport:
    """Per-class SLO attainment + goodput for one run, aggregated alongside
    a :class:`LatencyReport` (the harness emits both). Goodput is the
    SNIPPETS ch. 9 metric: output tokens of requests that met *every*
    applicable SLO, per second of makespan — a scheduler that finishes many
    requests late scores high throughput and low goodput. Dropped requests
    (shed / cancelled / rejected / failed) count as SLO misses in every
    attainment rate and contribute zero goodput."""
    policy: str
    n_requests: int                   # finished + dropped
    n_finished: int
    n_dropped: int
    makespan_s: float                 # last finish − first arrival
    goodput_tok_s: float
    throughput_tok_s: float
    slo_attainment: float             # over requests carrying ≥ 1 SLO
    ttft_attainment: float
    itl_attainment: float
    per_class: Tuple[ClassSLOStats, ...] = ()
    per_tenant: Tuple[TenantStats, ...] = ()

    def rows(self) -> str:
        head = (f"{self.policy:12s} n={self.n_requests:5d} "
                f"attain={self.slo_attainment:5.2f}  "
                f"goodput={self.goodput_tok_s:8.1f} tok/s  "
                f"tput={self.throughput_tok_s:8.1f} tok/s")
        return "\n".join([head] + [c.row() for c in self.per_class])

    def cls(self, name: str) -> ClassSLOStats:
        """Lookup one class row by name (KeyError when absent)."""
        for c in self.per_class:
            if c.name == name:
                return c
        raise KeyError(name)


def _tenant_stats(name: str, reqs: List[Request]) -> TenantStats:
    fin = [r for r in reqs if r.state is RequestState.FINISHED]
    ttft = np.asarray([r.first_token_time - r.arrival_time for r in fin
                       if r.first_token_time is not None], dtype=float)
    per_tok = np.asarray([r.per_token_latency() for r in fin], dtype=float)
    return TenantStats(
        name=name, n_requests=len(reqs),
        p50_ttft_s=_pct(ttft, 50), p99_ttft_s=_pct(ttft, 99),
        p99_per_token_latency=_pct(per_tok, 99),
        slo_attainment=_attainment([meets_slo(r) for r in reqs]),
    )


def slo_report(policy: str, finished: Sequence[Request],
               dropped: Sequence[Request] = ()) -> SLOReport:
    """Score one run against the per-request SLO annotations
    (``slo_ttft_s`` / ``slo_itl_s`` / ``priority_class`` / ``tenant`` —
    see :mod:`repro_torch.serving.workloads`). Requests without annotations are
    fine: they land in class ``"-"`` with NaN attainment and their tokens
    count toward both throughput and goodput (no SLO to violate)."""
    finished = list(finished)
    dropped = list(dropped)
    everything = finished + dropped
    if not everything:
        nan = float("nan")
        return SLOReport(policy=policy, n_requests=0, n_finished=0,
                         n_dropped=0, makespan_s=nan, goodput_tok_s=nan,
                         throughput_tok_s=nan, slo_attainment=nan,
                         ttft_attainment=nan, itl_attainment=nan)
    if finished:
        t0 = min(r.arrival_time for r in everything)
        t1 = max(r.finish_time for r in finished)
        makespan = max(t1 - t0, 1e-9)
    else:
        makespan = float("nan")

    def _goodput(reqs: List[Request]) -> float:
        good = sum(r.true_length for r in reqs
                   if r.state is RequestState.FINISHED
                   and meets_slo(r) is not False)
        return good / makespan

    def _throughput(reqs: List[Request]) -> float:
        return sum(r.true_length for r in reqs
                   if r.state is RequestState.FINISHED) / makespan

    by_class: Dict[str, List[Request]] = {}
    by_tenant: Dict[str, List[Request]] = {}
    for r in everything:
        by_class.setdefault(r.priority_class or "-", []).append(r)
        by_tenant.setdefault(r.tenant or "-", []).append(r)

    classes = []
    for name in sorted(by_class):
        reqs = by_class[name]
        fin = [r for r in reqs if r.state is RequestState.FINISHED]
        ttft = np.asarray([r.first_token_time - r.arrival_time for r in fin
                           if r.first_token_time is not None], dtype=float)
        itl = itl_samples(fin)
        classes.append(ClassSLOStats(
            name=name,
            priority=max((r.priority for r in reqs), default=0),
            n_requests=len(reqs), n_finished=len(fin),
            n_dropped=len(reqs) - len(fin),
            ttft_attainment=_attainment([meets_ttft(r) for r in reqs]),
            itl_attainment=_attainment([meets_itl(r) for r in reqs]),
            slo_attainment=_attainment([meets_slo(r) for r in reqs]),
            goodput_tok_s=_goodput(reqs),
            throughput_tok_s=_throughput(reqs),
            avg_ttft_s=_mean(ttft),
            p99_ttft_s=_pct(ttft, 99),
            p99_itl_s=_pct(itl, 99),
        ))

    return SLOReport(
        policy=policy,
        n_requests=len(everything),
        n_finished=len(finished),
        n_dropped=len(dropped),
        makespan_s=makespan,
        goodput_tok_s=_goodput(everything),
        throughput_tok_s=_throughput(everything),
        slo_attainment=_attainment([meets_slo(r) for r in everything]),
        ttft_attainment=_attainment([meets_ttft(r) for r in everything]),
        itl_attainment=_attainment([meets_itl(r) for r in everything]),
        per_class=tuple(classes),
        per_tenant=tuple(_tenant_stats(n, by_tenant[n])
                         for n in sorted(by_tenant)),
    )
