"""Request lifecycle shared by the real engine and the simulator."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    # Terminal non-success states (fault tolerance): a dropped request left
    # the system without completing and will never re-enter it. Which one
    # is recorded in ``Request.drop_reason`` too, for metrics.
    CANCELLED = "cancelled"   # deadline expired (admission or in-flight)
    SHED = "shed"             # load shedding under sustained overload
    REJECTED = "rejected"     # KV demand can never fit the cache budget
    FAILED = "failed"         # replica-failover retry budget exhausted


#: States a request never leaves.
TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.CANCELLED,
                             RequestState.SHED, RequestState.REJECTED,
                             RequestState.FAILED})


@dataclass(eq=False)
class Request:
    """One request's lifecycle record.

    ``eq=False`` is deliberate: requests are *identities*, not values. Two
    same-prompt arrivals in the same tick are field-identical, and dataclass
    value equality made queue membership tests (``Scheduler.defer``'s
    ``r not in reqs``, ``running.remove(victim)``) silently drop or evict
    the wrong one. Identity equality (and identity hashing) makes every
    list/set operation on queues refer to *this* request only.
    """
    req_id: int
    prompt: str
    arrival_time: float
    prompt_len: int                   # prefill tokens
    true_length: int                  # ground-truth decode tokens (completion)
    score: float = 0.0                # predicted total output length
    # Whether a policy scorer has annotated ``score``. An explicit flag, not
    # a ``score == 0.0`` sentinel: a legitimate predictor score of exactly
    # 0.0 must not look "unscored" and be re-scored on every add_requests.
    scored: bool = False
    # Iterative re-ranking (``rerank_interval`` on the serving core): the
    # priority key refreshed at the last re-rank, ``max(score − tokens_done,
    # floor)`` — predicted decode tokens *remaining*, not total. ``None``
    # means the write-once world: policies fall back to the arrival-time
    # score (or true length, for the oracle) exactly as before.
    remaining_est: Optional[float] = None
    state: RequestState = RequestState.WAITING
    # runtime bookkeeping
    start_time: Optional[float] = None        # admitted to running queue
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    tokens_done: int = 0
    # Chunked prefill: prompt tokens already resident in the KV cache, in the
    # *backend's* prompt-token space (``ExecutionBackend.prefill_total``; the
    # real engine pads prompts to its token bucket, the simulator uses
    # ``prompt_len``). A request only joins the decode batch once
    # ``prefilled_tokens >= prefill_total``. Reset to 0 on preemption
    # eviction — recompute semantics re-prefill from offset 0.
    prefilled_tokens: int = 0
    # Snapshot of ``prefill_total`` taken by the core at admission, so a
    # total that folds in recompute work (the simulator charges prompt +
    # already-generated tokens after preemption) stays frozen while the
    # request is resident instead of drifting as ``tokens_done`` grows.
    prefill_target: Optional[int] = None
    # Prefix caching: prompt tokens this request reused from the KV prefix
    # cache instead of re-prefilling, accumulated across (re-)admissions.
    # ``None`` means the serving core ran with caching disabled — metrics
    # report NaN rather than a misleading 0% hit rate; 0 is a true miss.
    cached_prefix_tokens: Optional[int] = None
    # Multi-tenant SLO workloads (repro_torch.serving.workloads): the tenant the
    # request belongs to, its priority-class name, a numeric priority
    # (higher = more important — overload shedding takes low-priority
    # victims first and exempts priority > 0 from the predicted-length
    # admission gate), and the class's latency SLO targets: TTFT
    # (arrival → first token) and mean inter-token gap, in seconds. All
    # optional — a request without them schedules exactly as before
    # (priority 0, no SLO) and SLO metrics report NaN.
    tenant: Optional[str] = None
    priority_class: Optional[str] = None
    priority: int = 0
    slo_ttft_s: Optional[float] = None
    slo_itl_s: Optional[float] = None
    boosted: bool = False                     # starvation-prevention flag
    preempt_count: int = 0                    # recompute-preemption evictions
    defer_count: int = 0                      # engine back-pressure deferrals
    # Fault tolerance. ``deadline``: absolute completion deadline in the
    # serving clock's timebase; the core cancels the request (terminal
    # CANCELLED) the moment the deadline passes — at admission or mid-flight
    # — and sheds it at admission when the current length estimate says it
    # can never be met. ``None`` = no deadline (the historical behaviour).
    deadline: Optional[float] = None
    # Times this request was failed over after a replica crash (its KV was
    # lost; it re-dispatched with recompute-from-prompt). ``None`` means the
    # run had no failover layer — metrics report NaN instead of 0.
    failovers: Optional[int] = None
    # Earliest time the router may re-dispatch this request (failover
    # backoff: ``backoff * 2**(failovers-1)`` after the crash).
    route_after: Optional[float] = None
    # KV admission-gate rejections while waiting (cumulative across
    # replicas); the router's affinity-starvation escape compares this
    # against its value at routing time.
    gate_rejections: int = 0
    # Why a dropped request left the system ("deadline", "overload",
    # "kv-infeasible", "failover-budget"); None for live/finished requests.
    drop_reason: Optional[str] = None
    # Preemptions suffered in a scheduling cycle whose ranks had just been
    # refreshed by iterative re-ranking. ``None`` means the run never
    # re-ranked — metrics report NaN instead of a misleading 0.
    rerank_preemptions: Optional[int] = None
    # Incremental KV reservation (``kv_reservation="incremental"`` on the
    # serving core): decode-time block-``grow`` denials charged while *this*
    # request was trying to take its next decode step, and the number of
    # times this request was preempted to free blocks for another request's
    # grow. ``None`` means the run reserved full demand at admission — the
    # metrics layer reports NaN instead of a misleading 0.
    grow_failures: Optional[int] = None
    grow_preemptions: Optional[int] = None
    # Per-token completion timestamps (only filled when the serving core is
    # created with ``record_token_times=True``): one entry per generated
    # token, so inter-token-latency percentiles can be computed from actual
    # gaps instead of the (finish-first)/n mean.
    token_times: list = field(default_factory=list)
    # Generated token ids (real engine only, gated by ``record_tokens``):
    # used to check chunked and unchunked serving emit identical outputs.
    generated_tokens: list = field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.tokens_done >= self.true_length

    def per_token_latency(self) -> float:
        """End-to-end latency / output length (the paper's metric, §IV)."""
        assert self.finish_time is not None
        return (self.finish_time - self.arrival_time) / max(self.true_length, 1)
