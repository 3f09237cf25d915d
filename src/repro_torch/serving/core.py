"""Unified serving step loop shared by the real JAX engine and the simulator.

Both execution modes used to hand-roll their own loop, and the two drifted:
the engine enforced the KV budget by reaching into the scheduler's queues,
while the simulator ignored the ``BlockAllocator`` entirely. ``ServingCore``
owns the one canonical cycle —

    arrival delivery → KV-aware admission → chunked prefill → decode
                     → retirement

— parameterized by an :class:`ExecutionBackend` (the jitted JAX engine or the
calibrated cost model) and a :class:`Clock` (wall time or discrete-event
time). KV back-pressure lives in the scheduling path itself: the core installs
an ``admit_hook`` on the scheduler that reserves cache blocks at admission
time, so a request that doesn't fit simply stays in W — no queue surgery, in
either mode. Preemption evictions release their reservation through the
scheduler's ``evict_hook`` the same way.

**Mixed prefill/decode steps (Sarathi-style chunked prefill).** PARS removes
head-of-line blocking at the *queue* level, but an unchunked loop still has
HOL blocking at the *step* level: a burst of long prompts monopolizes the
prefill phase and stalls every running decode until the whole burst is
resident. With ``prefill_chunk_tokens`` set, each :meth:`ServingCore.step`
spends at most that many prompt tokens on prefill — tracked per request via
``Request.prefilled_tokens`` — and then runs one decode iteration for every
request whose prompt is fully resident. Long prompts therefore stream into
the cache across many steps while decodes keep producing tokens in between;
TTFT of the long prompt pays for inter-token latency of everyone else.
``prefill_chunk_tokens=None`` (default) preserves the historical
prefill-to-completion behaviour exactly.

**Prefix caching** (``prefix_caching=True``). Real multi-user traffic shares
prompt prefixes — system prompts, few-shot templates — and re-prefilling
them per request wastes exactly the compute the scheduler protects TTFT
from. At admission the core hashes the request's prompt into block-sized
chunk chains (:func:`~repro_torch.serving.kv_cache.prefix_chunk_hashes`), asks the
allocator for the longest *committed* cached chain, and shares those blocks
instead of claiming fresh ones; the request then starts life with
``prefilled_tokens`` already at the cached offset, so chunk planning only
streams the non-shared suffix and the backend never recomputes the prefix
(the real engine copies the cached KV fragments into the request's lane,
the simulator simply charges fewer prefill tokens). A prompt's own blocks
become hitable (``allocator.commit``) the moment its prefill completes.
The hit is capped at ``prefill_target - 1`` tokens: the final prompt
position is always recomputed so the backend has logits to emit the first
output token from (vLLM does the same on a full-prompt hit).

**Fault tolerance.** Production serving must keep its invariants when
components break, so failure handling is part of the loop, not a wrapper:

* every :meth:`step` first fires an optional ``fault_hook`` (the injection
  point :mod:`repro_torch.serving.faults` attaches to — ``None`` on healthy runs,
  so the hot path carries no testing branches) and bumps ``step_count``;
* a crashed core (:meth:`crash` / ``inject_crash``) raises
  :class:`~repro_torch.serving.faults.ReplicaCrashed` from every probe, submit,
  and tick — the router's failure detector — and :meth:`crash` extracts the
  lost requests (their KV is gone: reservations freed, prefix cache
  cleared cold) for failover; :meth:`restart` rejoins it cold;
* per-request **deadlines** (``Request.deadline``) are enforced every step:
  past-deadline work is cancelled — in-flight requests free their blocks —
  and with ``deadline_time_per_token`` set, a waiting request whose
  predicted service time already overruns its deadline is cancelled at
  admission time instead of wasting prefill (terminal ``CANCELLED``);
* **load shedding**: when queue depth or KV pressure stays over its
  threshold for ``shed_sustain_steps`` consecutive steps, the core sheds
  the worst-ranked non-boosted waiting requests (terminal ``SHED``) and —
  via a gate composed through ``Scheduler.add_admit_gate`` — refuses
  admission to work predicted longer than ``shed_predicted_tokens``, so
  p99 TTFT of admitted traffic degrades gracefully instead of collapsing;
* a request whose admission demand can never fit the cache budget is
  terminally **rejected** at gate time (``REJECTED``) rather than deferred
  forever.

Dropped requests (cancelled / shed / rejected) land in ``ServingCore
.dropped``, never in ``finished`` — request conservation is
``finished + dropped + queued == submitted`` at all times.

New serving behavior lands here once and both modes inherit it — the
multi-replica front-end (:class:`~repro_torch.serving.router.ReplicaRouter`)
drives N of these cores through :meth:`ServingCore.tick` and the router
probes (``queue_depth`` / ``kv_pressure`` / ``predicted_remaining_tokens``
/ ``prefix_affinity_blocks`` / ``next_event_time``) without touching the
loop itself.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Protocol, Sequence,
                    Tuple)

from repro_torch.core.scheduler.request import Request, RequestState
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.faults import ReplicaCrashed
from repro_torch.serving.kv_cache import (UNBOUNDED_BLOCKS, BlockAllocator,
                                    prefix_chunk_hashes)

# One planned unit of prefill work: (request, start, end) in the backend's
# prompt-token space — prefill prompt tokens [start, end) of this request.
PrefillChunk = Tuple[Request, int, int]


class Clock(Protocol):
    def now(self) -> float: ...
    def wait_until(self, t: float) -> None: ...


class WallClock:
    """Real time, origin at construction."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait_until(self, t: float) -> None:
        # short sleep, then re-check: arrivals are delivered by the run loop
        if t > self.now():
            time.sleep(min(1e-4, max(t - self.now(), 0.0)))


class VirtualClock:
    """Discrete-event time: advances only when the loop says so."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def now(self) -> float:
        return self.t

    def wait_until(self, t: float) -> None:
        self.t = max(self.t, t)


class ExecutionBackend(Protocol):
    """What a backend must provide; see ``RealBackend`` / ``SimBackend``."""

    def attach(self, core: "ServingCore") -> None: ...

    def kv_demand(self, req: Request) -> int:
        """Tokens of KV cache this request will occupy while resident."""
        ...

    def prefill_total(self, req: Request) -> int:
        """Prompt tokens this backend must prefill before ``req`` can decode.

        The core plans chunks against this total and a request joins the
        decode batch once ``req.prefilled_tokens`` reaches it. Backends may
        exceed ``req.prompt_len`` (the real engine pads prompts to its token
        bucket; the simulator charges recompute tokens after preemption).
        """
        ...

    def prefill(self, chunks: Sequence[PrefillChunk], now: float) -> float:
        """Process planned prefill chunks; returns the updated time.

        Each ``(req, start, end)`` asks for prompt tokens [start, end) to be
        made KV-resident. ``start == 0`` is a request's first chunk (the
        backend claims residency, e.g. a cache slot); ``end ==
        prefill_total(req)`` completes its prompt (the backend emits the
        first output token). The core updates ``req.prefilled_tokens`` after
        this call returns.
        """
        ...

    def decode(self, now: float) -> float:
        """Advance every *fully prefilled* running request one token;
        returns the updated time."""
        ...

    def release(self, req: Request) -> None:
        """Free backend residency (slot, …) for a retired/evicted request."""
        ...

    def prefix_tokens(self, req: Request) -> Sequence[int]:
        """The token-id stream eligible for prefix sharing, in this
        backend's prompt-token space (the real engine's encoded prompt; the
        simulator's synthetic word-hash stream). Requests whose streams
        share a leading run of whole KV blocks share those blocks. Return
        ``()`` to opt a request out of caching."""
        ...


class ServingCore:
    """The single KV-aware step loop behind the engine and the simulator.

    Behavioural knobs are consolidated in one frozen
    :class:`~repro_torch.serving.config.ServingConfig` — the primary constructor
    is ``ServingCore(scheduler, backend, config=ServingConfig(...))``, with
    the scheduler/backend/allocator/clock *objects* passed alongside as
    wiring. The historical loose-kwargs form still works through a
    deprecation shim (it builds the same config via
    ``ServingConfig.from_kwargs``, so both paths are bit-identical), but
    new code and every in-repo helper construct configs. The knobs, briefly
    (full field docs on :class:`ServingConfig`):

    ``prefill_chunk_tokens`` — per-step prompt-token budget for mixed
    prefill/decode steps (``None`` = prefill each admitted request to
    completion in its admission step, the pre-chunking behaviour).

    ``record_token_times`` — have backends append a wall/virtual timestamp to
    ``Request.token_times`` per generated token, enabling gap-based
    inter-token-latency percentiles in :mod:`repro_torch.serving.metrics`.

    ``prefix_caching`` — share KV blocks between requests whose prompts have
    a common prefix (see module docstring). Off by default: caching changes
    which blocks admissions reserve, so the historical behaviour is opted
    into, never silently altered.

    ``rerank_interval`` / ``rerank_every_steps`` — iterative re-ranking
    (ELIS-style): refresh every queued request's priority key to its
    predicted *remaining* length (``max(score − tokens_done,
    rerank_floor)``) every that-many clock seconds and/or serving cycles.
    The refresh re-scores the waiting queue in one batched predictor call
    (``Policy.refresh``) and the very next scheduling cycle sorts, admits,
    and preempts by the refreshed keys — a long request that has emitted
    most of its predicted tokens stops losing to fresh short prompts.
    Because refreshed ranks can demote the same request repeatedly, the
    core installs a starvation bound on the scheduler
    (``pin_after_demotions = rerank_pin_after``, default 3): a request
    preempted or deferred more often is pinned boosted. Both knobs default
    to off — ranks stay write-once, bit-identical to the historical loop.

    ``kv_reservation`` — ``"full"`` (default, historical) reserves a
    request's worst-case ``backend.kv_demand`` at admission; a resident
    request can never stall on memory, but admission is gated on KV the
    request may not need for thousands of steps. ``"incremental"``
    (vLLM-style paged admission) reserves only the prompt plus one decode
    block up front and grows the reservation block-by-block as decode
    advances (:meth:`_grow_for_decode`) — admitted concurrency at a fixed
    KV budget rises accordingly. When a grow is denied, the lowest-ranked
    other running request is preempted (deterministic: scheduler policy
    key, then req_id; recompute semantics, counted in
    ``Request.grow_preemptions``) so half-decoded requests cannot deadlock
    waiting on each other.
    """

    def __init__(self, scheduler: Scheduler, backend: ExecutionBackend, *,
                 config: Optional[ServingConfig] = None,
                 allocator: Optional[BlockAllocator] = None,
                 clock: Optional[Clock] = None,
                 **legacy_kwargs) -> None:
        if legacy_kwargs:
            # Deprecation shim: the historical loose-kwargs constructor.
            # Translated through ServingConfig.from_kwargs so validation and
            # defaults are exactly the config path's (bit-identical runs are
            # pinned by tests/test_workloads.py).
            if config is not None:
                raise TypeError(
                    "pass either config=ServingConfig(...) or legacy "
                    f"keyword arguments, not both (got both config= and "
                    f"{sorted(legacy_kwargs)})")
            warnings.warn(
                "ServingCore(scheduler, backend, prefill_chunk_tokens=..., "
                "...) is deprecated; pass "
                "config=ServingConfig(...) instead",
                DeprecationWarning, stacklevel=2)
            config = ServingConfig.from_kwargs(**legacy_kwargs)
        self.config = config = config or ServingConfig()
        self.scheduler = scheduler
        self.backend = backend
        self.allocator = allocator or BlockAllocator.unbounded()
        self.clock: Clock = clock or WallClock()
        self.prefill_chunk_tokens = config.prefill_chunk_tokens
        self.record_token_times = config.record_token_times
        self.prefix_caching = config.prefix_caching
        self.kv_reservation = config.kv_reservation
        # Iterative re-ranking cadence: refresh priority keys to predicted
        # *remaining* length every ``rerank_interval`` clock seconds and/or
        # every ``rerank_every_steps`` serving cycles (either one firing
        # triggers a refresh). Off by default — ranks stay write-once.
        self.rerank_interval = config.rerank_interval
        self.rerank_every_steps = config.rerank_every_steps
        self.rerank_floor = config.rerank_floor
        self._rerank_enabled = config.rerank_enabled
        self._steps_since_rerank = 0
        self._last_rerank_t: Optional[float] = None
        if self._rerank_enabled and scheduler.pin_after_demotions is None:
            # starvation bound: re-ranking can demote the same request over
            # and over; pin it boosted after ``rerank_pin_after`` demotions
            scheduler.pin_after_demotions = config.rerank_pin_after
        # req_id -> full chunk-hash chain, computed once per residency: the
        # KV gate re-evaluates every waiting request each cycle under
        # back-pressure, and re-tokenizing + re-hashing a long shared prompt
        # there would make admission O(prompt_len) per cycle
        self._hash_memo: Dict[int, List[int]] = {}
        self.finished: List[Request] = []
        self._pending: Deque[Request] = deque()
        # --------------------------------------------------- fault tolerance
        # Terminally dropped requests (CANCELLED / SHED / REJECTED) — part of
        # request conservation, never of ``finished``.
        self.dropped: List[Request] = []
        # Per-step fault injection point (repro_torch.serving.faults attaches
        # here); ``None`` on healthy runs — the hot path stays branch-free.
        self.fault_hook: Optional[Callable[["ServingCore", float], None]] = None
        self.step_count = 0
        self._crashed = False
        # Deadlines: ``deadline_time_per_token`` (predicted seconds per
        # output token) turns a waiting request's length estimate into a
        # service-time estimate, enabling admission-time shedding of
        # unmeetable deadlines. Deadline enforcement itself activates the
        # first time a submitted request carries one.
        self.deadline_time_per_token = config.deadline_time_per_token
        self._deadlines_seen = False
        self.deadline_cancels = 0
        # Load shedding: sustained-overload detection plus the composed
        # admission gate (below).
        self.shed_queue_depth = config.shed_queue_depth
        self.shed_kv_pressure = config.shed_kv_pressure
        self.shed_sustain_steps = config.shed_sustain_steps
        self.shed_predicted_tokens = config.shed_predicted_tokens
        self._shed_enabled = config.shed_enabled
        self._overload_steps = 0
        self._shed_active = False
        self.shed_count = 0
        # Gate-time terminal rejection (a demand that can never fit).
        self.infeasible_rejections = 0
        self._reject_pending: List[Request] = []
        self._shed_marked: List[Request] = []
        scheduler.admit_hook = self._reserve
        scheduler.evict_hook = self._evict
        if self._shed_enabled and self.shed_predicted_tokens is not None:
            # runs BEFORE _reserve (gates added later run first), so a shed
            # veto can never leak a KV reservation
            scheduler.add_admit_gate(self._shed_gate)
        backend.attach(self)

    # ------------------------------------------------------------------ api
    def submit(self, requests: Sequence[Request]) -> None:
        self._check_alive()
        if not self._deadlines_seen:
            self._deadlines_seen = any(r.deadline is not None
                                       for r in requests)
        self._pending = deque(sorted([*self._pending, *requests],
                                     key=lambda r: r.arrival_time))

    # ------------------------------------------------------- crash lifecycle
    def _check_alive(self) -> None:
        if self._crashed:
            raise ReplicaCrashed("serving core is down")

    def inject_crash(self) -> None:
        """Mark this core dead without unwinding it — the next probe, submit,
        or tick raises :class:`ReplicaCrashed` (how a fault schedule or test
        kills a replica between steps)."""
        self._crashed = True

    def crash(self) -> List[Request]:
        """Kill this core and extract every request it was responsible for.

        Crash semantics: all KV on this replica is lost. Running requests'
        reservations and backend residency are released, partial prefill
        progress is discarded (failover is recompute-from-prompt), and the
        prefix cache is cleared cold — its committed blocks point at memory
        that no longer exists, so they must stop being hitable (backends
        drop their fragments via the evict listeners). The allocator object
        itself survives (backends hold references to it); only its contents
        reset. Returns the lost requests, in pending → waiting → running
        order, for the router to fail over."""
        self._crashed = True
        sched = self.scheduler
        lost = [*self._pending, *sched.waiting, *sched.running]
        for r in sched.running:
            self.allocator.free(r.req_id)
            self.backend.release(r)
        for r in lost:
            r.prefilled_tokens = 0
            r.prefill_target = None
        self._pending.clear()
        sched.waiting.clear()
        sched.running.clear()
        self._reject_pending.clear()
        self._shed_marked.clear()
        self.allocator.clear_cache()
        self._hash_memo.clear()
        self._overload_steps = 0
        self._shed_active = False
        return lost

    def restart(self) -> None:
        """Rejoin cold after :meth:`crash`: the core accepts work again with
        an empty cache — exactly a fresh replica, minus construction cost."""
        self._crashed = False

    def decode_ready(self, req: Request) -> bool:
        """True once a request's whole prompt is KV-resident (it may join
        the decode batch). Backends use this to filter ``running``."""
        return req.prefilled_tokens >= self._target(req)

    # -------------------------------------------------------- router probes
    # Read-only observations a multi-replica front-end routes by. None of
    # them mutate request or allocator state: a probed request may well be
    # routed to a different replica. Every probe checks liveness first —
    # probe failure (``ReplicaCrashed``) is the router's failure detector.
    def queue_depth(self) -> int:
        """Unfinished requests this core is responsible for: routed but not
        yet arrived, waiting, and running."""
        self._check_alive()
        return (len(self._pending) + len(self.scheduler.waiting)
                + len(self.scheduler.running))

    def kv_used_blocks(self) -> int:
        """Distinct KV blocks currently referenced (shared blocks once)."""
        self._check_alive()
        return self.allocator.used_blocks

    def kv_pressure(self) -> float:
        """Referenced fraction of the KV budget, in [0, 1]. Unbounded
        allocators report 0.0 — rank those replicas by
        :meth:`kv_used_blocks` instead."""
        self._check_alive()
        if self.allocator.total_blocks >= UNBOUNDED_BLOCKS:
            return 0.0
        return self.allocator.used_blocks / self.allocator.total_blocks

    def predicted_remaining_tokens(
            self, predicted_len: Callable[[Request], float]) -> float:
        """Predicted tokens of work left on this core: for every unfinished
        request it owns, the prompt tokens still to prefill plus
        ``max(predicted_len(req) - tokens_done, 0)`` predicted decode
        tokens. The router's ``predicted_shortest_queue`` policy sums PARS
        scores through this (``predicted_len`` maps a request to its
        predicted output length — typically ``req.score``).

        When iterative re-ranking has refreshed a request's remaining
        estimate (``Request.remaining_est``), the probe reads *that* —
        never the stale arrival score — so routing pressure decays as a
        replica's long requests approach completion, in lockstep with the
        keys its own scheduler ranks by."""
        self._check_alive()
        total = 0.0
        for r in (*self._pending, *self.scheduler.waiting,
                  *self.scheduler.running):
            target = (r.prefill_target if r.prefill_target is not None
                      else self.backend.prefill_total(r))
            total += max(target - r.prefilled_tokens, 0)
            if r.remaining_est is not None:
                total += r.remaining_est
            else:
                total += max(float(predicted_len(r)) - r.tokens_done, 0.0)
        return total

    def prefix_affinity_blocks(self, req: Request) -> int:
        """Committed cached blocks this core could share for ``req``'s
        prompt right now — the router's cache-affinity probe. 0 when prefix
        caching is off. Deliberately unmemoized (unlike
        :meth:`_prefix_hashes`): the request may be routed elsewhere, and a
        stale memo entry on a non-chosen replica would never be reclaimed."""
        self._check_alive()
        if not self.prefix_caching:
            return 0
        chain = prefix_chunk_hashes(self.backend.prefix_tokens(req),
                                    self.allocator.block_size)
        cap = (max(self.backend.prefill_total(req) - 1, 0)
               // self.allocator.block_size)
        return self.allocator.cached_prefix_blocks(chain[:cap])

    def next_event_time(self) -> float:
        """When this core next has something to do, in its clock's
        timebase: now if scheduled work exists, the first pending arrival
        otherwise, ``+inf`` when fully drained. The router advances the
        replica with the earliest next event (discrete-event order across
        replicas)."""
        self._check_alive()
        if self.scheduler.has_work:
            return self.clock.now()
        if self._pending:
            return max(self.clock.now(), self._pending[0].arrival_time)
        return float("inf")

    def _target(self, req: Request) -> int:
        """The request's frozen prefill total: snapshotted at admission so a
        backend total that folds in recompute work (the simulator charges
        prompt + generated tokens after preemption) doesn't drift while the
        request decodes."""
        if req.prefill_target is None:
            req.prefill_target = self.backend.prefill_total(req)
        return req.prefill_target

    def _prefix_hashes(self, req: Request) -> List[int]:
        """The request's shareable chunk-hash chain, capped so at least the
        last prompt position is always recomputed (the backend needs its
        logits to emit the first output token). Empty when caching is off."""
        if not self.prefix_caching:
            return []
        chain = self._hash_memo.get(req.req_id)
        if chain is None:
            chain = prefix_chunk_hashes(self.backend.prefix_tokens(req),
                                        self.allocator.block_size)
            self._hash_memo[req.req_id] = chain
        cap = max(self._target(req) - 1, 0) // self.allocator.block_size
        return chain[:cap]

    def _admission_need(self, req: Request) -> int:
        """KV tokens an admission must reserve. Full mode: the backend's
        worst-case demand. Incremental mode: the prompt (``prefill_target``)
        plus one decode block — decode growth is paid step-by-step."""
        need = self.backend.kv_demand(req)
        if self.kv_reservation == "incremental":
            need = min(self._target(req) + self.allocator.block_size, need)
        return need

    # ---------------------------------------------------------------- hooks
    def _reserve(self, req: Request) -> bool:
        """Scheduler admission gate: reserve KV blocks or keep the request
        in W (memory back-pressure, identical in both execution modes).

        Under ``kv_reservation="full"`` the *full* demand is reserved up
        front even under chunked prefill — a half-prefilled request can
        never stall on blocks its own decode phase needs. Under
        ``"incremental"`` only the prompt + first decode block is reserved
        (``_grow_for_decode`` pays for the rest). With prefix caching, the
        leading blocks that match a committed cached chain are shared
        rather than newly claimed, and the request starts prefill at the
        cached offset."""
        need = self._admission_need(req)
        hashes = self._prefix_hashes(req)
        if self.allocator.blocks_for(need) > self.allocator.total_blocks:
            # Certain infeasibility: the request's own block table would
            # exceed the whole cache — no amount of draining (or prefix
            # sharing, which reduces new claims but not table length) can
            # ever admit it. Deferring would wedge the loop forever; mark it
            # for terminal rejection (swept after this scheduling cycle).
            req.gate_rejections += 1
            self._reject_pending.append(req)
            return False
        if not self.allocator.can_allocate(need, hashes):
            req.gate_rejections += 1
            return False
        shared = self.allocator.allocate(req.req_id, need, hashes)
        if self.kv_reservation == "incremental":
            # None → 0 marks "incremental accounting active" (metrics stay
            # NaN-safe for full-reservation runs); preserved across
            # preemption re-admissions like ``cached_prefix_tokens``
            req.grow_failures = req.grow_failures or 0
            req.grow_preemptions = req.grow_preemptions or 0
        if self._rerank_enabled:
            # same None → 0 convention for the re-rank preemption counter
            req.rerank_preemptions = req.rerank_preemptions or 0
        if self.prefix_caching:
            cached = shared * self.allocator.block_size
            if cached:
                req.prefilled_tokens = cached
            # None → int marks "caching was on for this request" (metrics
            # stay NaN-safe when it is off); accumulates across preemption
            # re-admissions so tokens-saved reflects every avoided prefill
            req.cached_prefix_tokens = (req.cached_prefix_tokens or 0) + cached
        return True

    def _evict(self, req: Request) -> None:
        """Preemption eviction: blocks and backend residency come back.
        (The scheduler resets ``prefilled_tokens`` — a half-prefilled victim
        re-prefills from offset 0 on re-admission.)"""
        self.allocator.free(req.req_id)
        self.backend.release(req)

    def _retire(self, now: float) -> None:
        for r in self.scheduler.retire_finished(now):
            self.allocator.free(r.req_id)
            self.backend.release(r)
            self._hash_memo.pop(r.req_id, None)
            self.finished.append(r)

    # ------------------------------------------------ drops (terminal exits)
    def _drop(self, req: Request, now: float, state: RequestState,
              reason: str) -> None:
        """Terminal non-success exit: the request leaves the system for good.
        Any held resources are released (no-ops for never-admitted work)."""
        self.allocator.free(req.req_id)
        self.backend.release(req)
        req.state = state
        req.drop_reason = reason
        req.finish_time = now
        self._hash_memo.pop(req.req_id, None)
        self.dropped.append(req)

    def _drop_from_waiting(self, reqs: List[Request], now: float,
                           state: RequestState, reason: str) -> None:
        ids = {id(r) for r in reqs}
        self.scheduler.waiting = [r for r in self.scheduler.waiting
                                  if id(r) not in ids]
        for r in reqs:
            self._drop(r, now, state, reason)

    def _sweep_marked(self, now: float) -> None:
        """Finalize requests the admission gates marked this cycle (they
        stayed in W through the scan; the scan must not mutate the queue it
        iterates)."""
        if self._reject_pending:
            self.infeasible_rejections += len(self._reject_pending)
            self._drop_from_waiting(self._reject_pending, now,
                                    RequestState.REJECTED, "kv-infeasible")
            self._reject_pending = []
        if self._shed_marked:
            self.shed_count += len(self._shed_marked)
            self._drop_from_waiting(self._shed_marked, now,
                                    RequestState.SHED, "overload")
            self._shed_marked = []

    # ------------------------------------------------------------- deadlines
    def _estimate_len(self, req: Request) -> Optional[float]:
        """Best current output-length estimate: the refreshed remaining
        estimate, else the predictor score. ``None`` when the run has no
        basis (unscored under fcfs) — estimate-gated decisions then skip."""
        if req.remaining_est is not None:
            return req.remaining_est
        if req.scored:
            return req.score
        return None

    def _enforce_deadlines(self, now: float) -> None:
        """Cancel past-deadline work (terminal ``CANCELLED``): in-flight
        requests free their blocks and backend residency mid-stream; waiting
        requests are also cancelled *pre-admission* when
        ``deadline_time_per_token`` says their predicted service time
        already overruns the deadline — admitting them would only burn
        prefill the SLO can never credit."""
        expired_r = [r for r in self.scheduler.running
                     if r.deadline is not None and now > r.deadline]
        for r in expired_r:
            self.scheduler.running.remove(r)
            self._drop(r, now, RequestState.CANCELLED, "deadline")
        tpt = self.deadline_time_per_token
        expired_w = []
        for r in self.scheduler.waiting:
            if r.deadline is None:
                continue
            if now > r.deadline:
                expired_w.append(r)
            elif tpt is not None:
                est = self._estimate_len(r)
                if est is not None and now + tpt * est > r.deadline:
                    expired_w.append(r)
        if expired_w:
            self._drop_from_waiting(expired_w, now, RequestState.CANCELLED,
                                    "deadline")
        self.deadline_cancels += len(expired_r) + len(expired_w)

    # ---------------------------------------------------------- load shedding
    def _shed_victim_key(self, r: Request, now: float) -> Tuple:
        """Shed-preference ordering; victims are taken from the *end* of a
        list sorted ascending by this key. Class-aware: a waiting request
        whose TTFT SLO is already blown sheds first (its tokens can never
        count toward goodput again), then lower ``Request.priority`` classes
        before higher, then the scheduler's own rank (worst-ranked last).
        Without class/SLO annotations every component but the rank is
        constant, reducing exactly to the historical worst-ranked-tail
        ordering."""
        ttft_blown = (r.slo_ttft_s is not None
                      and r.first_token_time is None
                      and now - r.arrival_time > r.slo_ttft_s)
        return (1 if ttft_blown else 0, -r.priority,
                self.scheduler._sort_key(r))

    def _update_shedding(self, now: float) -> None:
        """Sustained-overload detection + tail shedding. Overload = queue
        depth over ``shed_queue_depth`` and/or KV pressure over
        ``shed_kv_pressure`` for ``shed_sustain_steps`` *consecutive* steps
        (a one-step burst never sheds). While active, the least-worth-keeping
        non-boosted waiting requests are shed (:meth:`_shed_victim_key`:
        blown-SLO first, then low priority classes, then worst rank): down
        to the queue-depth target when that trigger fired, one per step
        under pure KV pressure. Boosted (starvation-pinned) requests are
        never shed."""
        over_queue = (self.shed_queue_depth is not None
                      and len(self.scheduler.waiting) > self.shed_queue_depth)
        over_kv = (self.shed_kv_pressure is not None
                   and self.kv_pressure() >= self.shed_kv_pressure)
        self._overload_steps = (self._overload_steps + 1
                                if (over_queue or over_kv) else 0)
        self._shed_active = self._overload_steps >= self.shed_sustain_steps
        if not self._shed_active:
            return
        sheddable = sorted((r for r in self.scheduler.waiting
                            if not r.boosted),
                           key=lambda r: self._shed_victim_key(r, now))
        if over_queue:
            n = len(self.scheduler.waiting) - self.shed_queue_depth
        else:
            n = 1
        victims = sheddable[len(sheddable) - min(n, len(sheddable)):]
        if victims:
            self.shed_count += len(victims)
            self._drop_from_waiting(victims, now, RequestState.SHED,
                                    "overload")

    def _shed_gate(self, req: Request) -> bool:
        """Admission gate (composed via ``Scheduler.add_admit_gate``, so it
        runs before the KV hook reserves anything): while overload shedding
        is active, refuse work predicted longer than
        ``shed_predicted_tokens`` — under overload, admitting a long request
        delays every queued short one behind it. Class-aware: requests from
        priority > 0 classes are exempt — their SLO is what shedding exists
        to protect, so the gate only turns away best-effort traffic."""
        if not self._shed_active or req.boosted or req.priority > 0:
            return True
        est = self._estimate_len(req)
        if est is not None and est >= self.shed_predicted_tokens:
            self._shed_marked.append(req)
            return False
        return True

    # ----------------------------------------------------------------- loop
    def _plan_chunks(self) -> List[PrefillChunk]:
        """Plan this step's prefill work under the chunk-token budget.

        Walks ``running`` in admission order (oldest prefill first, so
        earlier arrivals reach their first token sooner). A request whose
        whole remainder fits the remaining budget takes it and leaves the
        rest for later requests (Sarathi-style chunk packing). A *partial*
        take — splitting a prompt mid-stream — is only allowed as the
        step's first planned chunk, where it gets the full budget: that
        keeps every chunk length in {whole padded prompts, remainders of
        them, the budget itself}, so the real engine's jitted dispatch
        shapes stay inside the warmed (bucket ∪ chunk) grid instead of
        fragmenting into arbitrary leftover lengths. A request skipped for
        that reason is head-of-line next step, so it cannot starve.

        With no budget configured every prefilling request gets its full
        remainder in one chunk, which is exactly the historical
        prefill-to-completion step.
        """
        budget = self.prefill_chunk_tokens or float("inf")
        chunks: List[PrefillChunk] = []
        for r in self.scheduler.running:
            if budget <= 0:
                break
            remaining = self._target(r) - r.prefilled_tokens
            if remaining <= 0:
                continue
            if remaining <= budget:
                take = remaining
            elif not chunks:
                take = int(budget)
            else:
                continue        # no mid-pack partials (bounded shapes)
            chunks.append((r, r.prefilled_tokens, r.prefilled_tokens + take))
            budget -= take
        return chunks

    # ------------------------------------------------- incremental reservation
    def _grow_victim(self, req: Request) -> Optional[Request]:
        """Deterministic preemption fallback for a denied decode-time grow:
        the lowest-ranked *other* running request still holding blocks —
        non-boosted before boosted, then worst policy key, req_id as the
        final tiebreak so both execution modes pick the same victim."""
        pool = [v for v in self.scheduler.running
                if v is not req and self.allocator.reserved(v.req_id)]
        if not pool:
            return None
        return max(pool, key=lambda v: (not v.boosted,
                                        self.scheduler.policy.key(v),
                                        v.req_id))

    def _preempt_for_grow(self, victim: Request) -> None:
        """Evict ``victim`` back to W with recompute semantics (mirrors
        ``Scheduler._preempt``: partial KV residency is lost, re-admission
        re-prefills from offset 0 and re-snapshots the prefill target)."""
        self.scheduler.running.remove(victim)
        victim.state = RequestState.WAITING
        victim.preempt_count += 1
        victim.grow_preemptions = (victim.grow_preemptions or 0) + 1
        self.scheduler._note_demotion(victim)   # starvation bound applies too
        victim.prefilled_tokens = 0
        victim.prefill_target = None
        self._evict(victim)
        self.scheduler.waiting.append(victim)

    def _grow_for_decode(self) -> None:
        """Incremental mode: before a decode iteration, grow every
        decode-ready request's reservation to cover the KV row the next
        token writes (``prefill_target + tokens_done + 1`` tokens, capped
        at the backend's full demand — one new block every
        ``block_size`` steps). A denied grow preempts the lowest-ranked
        other running request and retries; a request that cannot be grown
        even with the batch to itself can never finish, which is a genuine
        capacity error, not back-pressure."""
        for r in list(self.scheduler.running):
            if r.state is not RequestState.RUNNING or not self.decode_ready(r):
                continue
            need = min(self._target(r) + r.tokens_done + 1,
                       self.backend.kv_demand(r))
            while True:
                delta = (self.allocator.blocks_for(need)
                         - self.allocator.reserved(r.req_id))
                if delta <= 0 or self.allocator.grow(r.req_id, delta):
                    break
                r.grow_failures = (r.grow_failures or 0) + 1
                if self.allocator.free_blocks >= delta:
                    # Denied despite sufficient free capacity: the denial is
                    # not memory pressure (an injected grow storm), so
                    # evicting victims cannot help — self-preempt with
                    # recompute semantics and retry on re-admission.
                    # Unreachable without faults: ``grow`` fails only when
                    # ``delta`` exceeds free (incl. LRU-parked) blocks.
                    self._preempt_for_grow(r)
                    break
                victim = self._grow_victim(r)
                if victim is None:
                    if (self.allocator.blocks_for(need)
                            > self.allocator.total_blocks):
                        raise MemoryError(
                            f"KV budget cannot sustain request {r.req_id} "
                            f"even alone: needs "
                            f"{self.allocator.blocks_for(need)} "
                            f"blocks of {self.allocator.block_size}, cache "
                            f"has {self.allocator.total_blocks} "
                            f"({self.allocator.free_blocks} free)")
                    # Transient denial with nobody to evict while feasible
                    # alone — same storm-shaped cause, same recovery.
                    self._preempt_for_grow(r)
                    break
                self._preempt_for_grow(victim)

    def _maybe_rerank(self, now: float) -> None:
        """Fire a priority-key refresh when the configured cadence is due —
        *before* this cycle's ``schedule`` call, so the refreshed ranks
        drive its sort, admission order, and preemption victim choice."""
        if not self._rerank_enabled:
            return
        due = (self.rerank_every_steps is not None
               and self._steps_since_rerank >= self.rerank_every_steps)
        if self.rerank_interval is not None:
            if self._last_rerank_t is None:
                self._last_rerank_t = now      # cadence origin: first step
            elif now - self._last_rerank_t >= self.rerank_interval:
                due = True
        if due:
            self.scheduler.rerank(now, floor=self.rerank_floor)
            self._steps_since_rerank = 0
            self._last_rerank_t = now

    @property
    def rerank_count(self) -> int:
        """Priority-key refreshes performed so far (scheduler-owned)."""
        return self.scheduler.rerank_count

    def step(self, now: float) -> float:
        """One mixed serving cycle: fault hook → deadlines/shedding → admit
        → prefill ≤ chunk tokens → one decode token for every fully
        prefilled running request → retire. Every fault-tolerance stage is
        a no-op (a flag test) unless its feature was configured."""
        self.step_count += 1
        if self.fault_hook is not None:
            self.fault_hook(self, now)
        if self._deadlines_seen:
            self._enforce_deadlines(now)
        if self._shed_enabled:
            self._update_shedding(now)
        self._maybe_rerank(now)
        self._steps_since_rerank += 1
        self.scheduler.schedule(now)
        if self._reject_pending or self._shed_marked:
            self._sweep_marked(now)
        chunks = self._plan_chunks()
        if chunks:
            now = self.backend.prefill(chunks, now)
            for req, _start, end in chunks:
                req.prefilled_tokens = end
                if self.prefix_caching and end >= self._target(req):
                    # prompt fully resident: its content-named blocks become
                    # hitable for later admissions (the real backend stored
                    # the matching KV fragments during this prefill call)
                    self.allocator.commit(req.req_id)
            self._retire(now)            # true_length == 1 finishes at prefill
        if self.scheduler.running:
            if self.kv_reservation == "incremental":
                self._grow_for_decode()
            if self.scheduler.running:   # grow preemption may have drained R
                now = self.backend.decode(now)
            self._retire(now)
        return now

    def tick(self, *,
             on_step: Optional[Callable[["ServingCore", float], None]] = None,
             ) -> Optional[float]:
        """One run-loop iteration — the step-one-replica API.

        Delivers due arrivals from the pending deque, takes one serving
        :meth:`step` if there is scheduled work (or fast-forwards the clock
        to the next arrival if not), and returns the core's clock time
        afterwards — ``None`` when the core is fully drained. ``run()`` is a
        loop over this; the multi-replica router interleaves ``tick()``
        calls across replicas instead, so a front-end drives N cores
        without duplicating any of the loop's arrival/progress semantics.

        Raises ``MemoryError`` when the core is wedged: the KV gate rejects
        every waiting request, nothing is executing, and no future arrival
        exists that could drain first (admission depends only on allocator
        state, so a wedge with an empty pending deque is permanent). With
        gate-time infeasibility rejection this is a defensive dead path —
        a request that can never fit exits terminally ``REJECTED`` at its
        first admission scan instead of wedging the loop."""
        self._check_alive()
        if not (self._pending or self.scheduler.has_work):
            return None
        now = self.clock.now()
        arrived = []
        while self._pending and self._pending[0].arrival_time <= now:
            arrived.append(self._pending.popleft())
        if arrived:
            self.scheduler.add_requests(arrived)
        if not self.scheduler.has_work:
            self.clock.wait_until(self._pending[0].arrival_time)
            return self.clock.now()
        running_before = bool(self.scheduler.running)
        finished_before = len(self.finished)
        dropped_before = len(self.dropped)
        new_now = self.step(now)
        if on_step is not None:
            on_step(self, new_now)
        progressed = (new_now != now or running_before
                      or self.scheduler.running
                      or len(self.finished) > finished_before
                      or len(self.dropped) > dropped_before)
        if not progressed:
            # KV gate rejected everything and nothing is executing
            if self._pending:
                self.clock.wait_until(self._pending[0].arrival_time)
                return self.clock.now()

            # effective demand: blocks a request must newly claim, after
            # subtracting the cached-prefix blocks it would share — with
            # caching on, the cheapest-to-admit request is the one with
            # the smallest *non-shared* footprint, not the smallest
            # prompt (its full demand may exceed what admission needs)
            def _new_blocks(r: Request) -> int:
                return (self.allocator.blocks_for(self._admission_need(r))
                        - self.allocator.cached_prefix_blocks(
                            self._prefix_hashes(r)))
            smallest = min(self.scheduler.waiting, key=_new_blocks)
            tokens = self._admission_need(smallest)
            shared = self.allocator.cached_prefix_blocks(
                self._prefix_hashes(smallest))
            cached_note = (f" ({shared} reusable from the prefix cache)"
                           if shared else "")
            raise MemoryError(
                f"KV budget can never admit remaining requests: request "
                f"{smallest.req_id} has the smallest demand, "
                f"{tokens} tokens = {self.allocator.blocks_for(tokens)} "
                f"blocks of {self.allocator.block_size}{cached_note}, "
                f"but the cache only has {self.allocator.total_blocks} "
                f"blocks ({self.allocator.free_blocks} free)")
        self.clock.wait_until(new_now)
        return new_now

    def run(self, *, max_time: float = float("inf"), log_every: float = 0.0,
            log_fn=print,
            on_step: Optional[Callable[["ServingCore", float], None]] = None,
            ) -> List[Request]:
        """Serve everything submitted; returns the finished requests.

        ``on_step(core, now)`` fires after every serving cycle — benchmark
        probes sample batch occupancy / allocator state through it without
        patching the loop."""
        last_log = 0.0
        total = len(self._pending) + len(self.finished) + \
            len(self.scheduler.waiting) + len(self.scheduler.running)
        while self._pending or self.scheduler.has_work:
            if self.clock.now() >= max_time:
                break
            new_now = self.tick(on_step=on_step)
            if new_now is None:
                break
            if log_every and new_now - last_log > log_every:
                last_log = new_now
                log_fn(f"[core t={new_now:8.2f}s] "
                       f"running={len(self.scheduler.running)} "
                       f"waiting={len(self.scheduler.waiting)} "
                       f"finished={len(self.finished)}/{total}")
        self._retire(self.clock.now())
        return self.finished
