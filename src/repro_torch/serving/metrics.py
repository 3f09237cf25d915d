"""Serving metrics: the subset of the reference metrics module that
:func:`repro_torch.serving.engine.serve` returns.

``report`` turns finished requests into a :class:`LatencyReport` (the
paper's average and p90 per-token latency, TTFT, inter-token-latency
percentiles, throughput, prefix-cache and fault counters), and
:class:`RunCounters` bundles the optional run counters. The definitions are
verbatim copies of ``repro/serving/metrics.py``; the multi-replica and SLO
reports are not part of this port yet.
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
