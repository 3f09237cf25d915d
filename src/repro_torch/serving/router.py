"""Multi-replica front-end: predictor-aware, cache-affinity request routing.

One engine replica saturates long before "heavy traffic from millions of
users" does; the production shape is N data-parallel replicas behind one
front-end. :class:`ReplicaRouter` is that front-end: it owns the global
arrival queue and dispatches each request to one of N per-replica
:class:`~repro_torch.serving.core.ServingCore` loops (Real or Sim backends — the
router never looks past the core's probe API). Routing reuses the same PARS
signal the in-replica scheduler ranks by, one level up:

* ``round_robin`` — cycle replicas in index order (the baseline every other
  policy is judged against).
* ``least_kv_pressure`` — the replica with the lowest referenced fraction of
  its KV budget (``ServingCore.kv_pressure``; absolute ``kv_used_blocks``
  breaks ties, so unbounded sim allocators still rank by load), then the
  shallowest queue.
* ``predicted_shortest_queue`` — the replica with the least *predicted
  remaining work*: for every unfinished request a replica owns, prompt
  tokens still to prefill plus ``max(predicted_len(r) − tokens_done, 0)``
  predicted decode tokens (``ServingCore.predicted_remaining_tokens``).
  ``predicted_len`` defaults to the PARS score annotated on the request —
  the ELIS-style dispatch-by-predicted-remaining-work rule applied across
  replicas instead of within one queue.
* ``prefix_affinity`` — the replica whose allocator already holds the
  longest *committed* chain-hash prefix of the request's prompt
  (``ServingCore.prefix_affinity_blocks``), so shared system prompts keep
  hitting the same replica's prefix cache instead of re-prefilling N times;
  replicas tie at zero affinity fall back to the ``least_kv_pressure``
  ordering. This is cross-replica cache *sharing* done as cache-aware
  routing — no KV bytes ever migrate between replicas.

Every choice is deterministic: metric policies take the per-replica argmin
of an explicit key tuple (lists indexed in replica order — no set/dict
iteration anywhere), and exact ties are broken by a ``random.Random(seed)``
owned by the router, so a fixed trace + fixed policy reproduces the same
assignment sequence run over run.

**Event order across replicas.** Each replica keeps its own clock (virtual
or wall). The router advances whichever replica has the earliest
``next_event_time()`` one :meth:`~repro_torch.serving.core.ServingCore.tick` at a
time, and routes a pending arrival only once every replica's next event is
at-or-past its arrival time — the discrete-event guarantee that routing
probes observe replica state *as of the arrival*, not as of whenever the
trace was submitted. With one replica this reduces exactly to the core's
own ``run()`` loop (the N=1 parity tests assert bit-identical outputs and
equal metrics against a bare ``ServingCore``).

**Admission stays the replica's.** Routing hands a request to a replica's
pending queue; actually entering that replica's running batch still goes
through its scheduler's ``admit_hook`` KV gate. The router composes a
per-replica gate onto that same hook (``Scheduler.add_admit_gate``) to
count admission attempts — the congestion signal reported per replica —
rather than inventing a parallel admission mechanism.

**Replica failover.** Every probe and tick is a liveness check: a replica
whose core raises :class:`~repro_torch.serving.faults.ReplicaCrashed` is marked
unhealthy and leaves the routing pool immediately. Its in-flight requests
are *lost KV* — there is nothing to drain — so the router extracts them
(``ServingCore.crash``), strips their assignment, and re-dispatches each to
a healthy replica with recompute-from-prompt semantics, after an
exponential-backoff delay (``failover_backoff_s · 2^(failovers−1)``) and
under a bounded retry budget (``max_failovers``; a request that keeps
landing on dying replicas exits terminally ``FAILED`` instead of looping
forever). Restarts are scheduled through :meth:`schedule_restart` (a fault
schedule calls it from ``on_replica_down``): at the given global event
count the replica rejoins the pool *cold* — empty queues, empty prefix
cache — and routing sees it as a fresh replica. Request conservation is a
router-level invariant: every submitted request is at all times in exactly
one of pending / retry-backoff / exactly-one-replica / finished / dropped.

**Routing-aware starvation bound.** ``affinity_escape_after=K`` releases a
request that the KV gate has rejected ≥ K times on the replica it was
routed to (typically its warm prefix-affinity replica): the router pulls it
back and re-dispatches it to a *different* replica, trading the warm cache
for actually running — the cross-replica analogue of the scheduler's
boost-after-starvation rule.
"""
from __future__ import annotations

import random
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.request import Request, RequestState
from repro_torch.serving.core import ServingCore
from repro_torch.serving.faults import ReplicaCrashed
from repro_torch.serving.metrics import RouterReport, RunCounters, router_report

ROUTING_POLICIES = ("round_robin", "least_kv_pressure",
                    "predicted_shortest_queue", "prefix_affinity")


def score_predicted_len(req: Request) -> float:
    """Default predicted output length: the PARS score the scheduling policy
    annotated at arrival, clipped at 0 (scores are relative ranks, so an
    unannotated request predicts zero remaining decode tokens and routes by
    prefill work + queue size alone). Only a fallback: when iterative
    re-ranking is on, ``ServingCore.predicted_remaining_tokens`` reads the
    refreshed ``Request.remaining_est`` instead of calling this."""
    return max(req.score, 0.0)


class ReplicaRouter:
    """Front-end dispatcher over N independent ``ServingCore`` replicas.

    ``replicas`` — already-constructed cores (own scheduler, allocator,
    backend, clock each; nothing is shared between them).
    ``policy`` — one of :data:`ROUTING_POLICIES`.
    ``predicted_len`` — request → predicted output length, used by
    ``predicted_shortest_queue`` (default: the request's PARS ``score``).
    ``seed`` — seeds the tie-break RNG, making exact-tie choices
    reproducible run over run.
    ``max_failovers`` — crash-failover retries per request before it exits
    terminally ``FAILED``.
    ``failover_backoff_s`` — base of the exponential re-dispatch backoff
    after a crash (``backoff · 2^(failovers−1)``).
    ``affinity_escape_after`` — release a request KV-gate-rejected this many
    times on its routed replica to route elsewhere (``None`` = never).
    """

    def __init__(self, replicas: Sequence[ServingCore], *,
                 policy: str = "round_robin",
                 predicted_len: Optional[Callable[[Request], float]] = None,
                 seed: int = 0,
                 max_failovers: int = 3,
                 failover_backoff_s: float = 0.5,
                 affinity_escape_after: Optional[int] = None) -> None:
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"policy must be one of {ROUTING_POLICIES}, "
                             f"got {policy!r}")
        if not replicas:
            raise ValueError("need at least one replica")
        if affinity_escape_after is not None and affinity_escape_after < 1:
            raise ValueError("affinity_escape_after must be >= 1 or None")
        self.replicas: List[ServingCore] = list(replicas)
        self.policy = policy
        self.predicted_len = predicted_len or score_predicted_len
        self._rng = random.Random(seed)
        self._pending: Deque[Request] = deque()
        self._rr_next = 0
        # req_id -> replica index, and the dispatch-ordered log the
        # determinism tests compare run over run
        self.assignments: Dict[int, int] = {}
        self.assignment_log: List[Tuple[int, int]] = []
        self.admit_attempts: List[int] = [0] * len(self.replicas)
        # ----------------------------------------------------------- failover
        self.max_failovers = max_failovers
        self.failover_backoff_s = failover_backoff_s
        self.affinity_escape_after = affinity_escape_after
        self.healthy: List[bool] = [True] * len(self.replicas)
        self.crash_count: List[int] = [0] * len(self.replicas)
        self.restarts: List[int] = [0] * len(self.replicas)
        self.redispatches = 0                 # failover + escape re-routes
        self._routed_ids: set = set()         # ever-dispatched req_ids
        self.dropped: List[Request] = []      # FAILED (budget exhausted)
        # requests waiting out their failover backoff, sorted by
        # (route_after, req_id)
        self._retry: List[Request] = []
        # replica -> global event count at which to restart it
        self._restart_at: Dict[int, int] = {}
        # req_id -> gate_rejections at its last dispatch (the affinity
        # escape counts rejections *since routing*, not lifetime)
        self._rejections_at_route: Dict[int, int] = {}
        self.event_count = 0
        # per-event fault injection point (repro_torch.serving.faults attaches
        # here); ``None`` on healthy runs
        self.fault_hook: Optional[Callable[["ReplicaRouter"], None]] = None
        # fired after a replica is marked down (fault schedules hook restart
        # planning here); signature ``(router, replica_idx)``
        self.on_replica_down: Optional[
            Callable[["ReplicaRouter", int], None]] = None
        for i, core in enumerate(self.replicas):
            core.scheduler.add_admit_gate(self._admit_gate(i))

    def _admit_gate(self, idx: int) -> Callable[[Request], bool]:
        """Observer gate composed onto replica ``idx``'s admit_hook: counts
        every admission attempt (deferral pressure shows up as attempts ≫
        served requests) without ever vetoing one."""
        def gate(_req: Request) -> bool:
            self.admit_attempts[idx] += 1
            return True
        return gate

    # --------------------------------------------------------------- routing
    def submit(self, requests: Sequence[Request]) -> None:
        """Queue arrivals on the global front-end queue (merged by arrival
        time, same convention as ``ServingCore.submit``)."""
        self._pending = deque(sorted([*self._pending, *requests],
                                     key=lambda r: r.arrival_time))

    def _key_for(self, idx: int, req: Request) -> Tuple:
        """Replica ``idx``'s routing key for the configured policy (lower =
        better). May raise ``ReplicaCrashed`` — probe failure is how a
        not-yet-detected dead replica is discovered mid-choice."""
        c = self.replicas[idx]
        if self.policy == "least_kv_pressure":
            return (c.kv_pressure(), c.kv_used_blocks(), c.queue_depth())
        if self.policy == "predicted_shortest_queue":
            return (c.predicted_remaining_tokens(self.predicted_len),
                    c.queue_depth())
        if self.policy == "prefix_affinity":
            # longest committed prefix wins; zero-affinity replicas compare
            # by exactly the least_kv_pressure ordering (the fallback)
            return (-c.prefix_affinity_blocks(req), c.kv_pressure(),
                    c.kv_used_blocks(), c.queue_depth())
        raise AssertionError(self.policy)

    def _keys(self, req: Request,
              exclude: frozenset = frozenset()) -> List[Optional[Tuple]]:
        """Per-replica routing keys, indexed in replica order; ``None`` for
        replicas out of the running (unhealthy, excluded, or found dead by
        the probe itself — those are failed over on the spot)."""
        keys: List[Optional[Tuple]] = []
        for i in range(len(self.replicas)):
            if not self.healthy[i] or i in exclude:
                keys.append(None)
                continue
            try:
                keys.append(self._key_for(i, req))
            except ReplicaCrashed:
                self._fail_replica(i)
                keys.append(None)
        return keys

    def choose(self, req: Request,
               exclude: frozenset = frozenset()) -> Optional[int]:
        """Pick the replica for one request. ``round_robin`` cycles (skipping
        unhealthy replicas); metric policies take the argmin of
        :meth:`_keys`, exact ties broken by the seeded RNG (never by
        iteration order of anything unordered). ``None`` when no healthy
        non-excluded replica exists."""
        if self.policy == "round_robin":
            for _ in range(len(self.replicas)):
                idx = self._rr_next
                self._rr_next = (self._rr_next + 1) % len(self.replicas)
                if self.healthy[idx] and idx not in exclude:
                    return idx
            return None
        keys = self._keys(req, exclude)
        live = [k for k in keys if k is not None]
        if not live:
            return None
        best = min(live)
        tied = [i for i, k in enumerate(keys) if k == best]
        return tied[0] if len(tied) == 1 else self._rng.choice(tied)

    def dispatch(self, req: Request,
                 *, exclude: frozenset = frozenset()) -> Optional[int]:
        """Route one request now: record the assignment and hand it to the
        chosen replica's pending queue (its own arrival/admission machinery
        takes over from there). A request seen before (failover retry or
        affinity escape — including one that bounced through the front-end
        queue because no replica was healthy when its retry came due)
        counts as a re-route, so ``assignment_log`` uniqueness accounting
        stays exact: duplicates in the log == ``redispatches``. Returns the
        chosen replica, or ``None`` (request requeued at the front-end)
        when no healthy replica is available."""
        idx = self.choose(req, exclude)
        while idx is not None:
            try:
                self.replicas[idx].submit([req])
                break
            except ReplicaCrashed:
                # an undiscovered dead replica (round_robin never probes,
                # so the hand-off itself is the liveness check here): fail
                # it over and re-choose for this request on the spot
                self._fail_replica(idx)
                idx = self.choose(req, exclude)
        if idx is None:
            self._pending.appendleft(req)
            return None
        self.assignments[req.req_id] = idx
        self.assignment_log.append((req.req_id, idx))
        self._rejections_at_route[req.req_id] = req.gate_rejections
        if req.req_id in self._routed_ids:
            self.redispatches += 1
        else:
            self._routed_ids.add(req.req_id)
        return idx

    # -------------------------------------------------------------- failover
    def _fail_replica(self, idx: int) -> None:
        """Mark replica ``idx`` dead and fail its requests over. Idempotent
        (probe failure and tick failure can both report the same crash).

        The crashed core's requests lost their KV; each one is stripped of
        its assignment and either queued for re-dispatch after exponential
        backoff, or — past ``max_failovers`` — exits terminally ``FAILED``.
        """
        if not self.healthy[idx]:
            return
        self.healthy[idx] = False
        self.crash_count[idx] += 1
        core = self.replicas[idx]
        now = core.clock.now()
        for r in core.crash():
            self.assignments.pop(r.req_id, None)
            self._rejections_at_route.pop(r.req_id, None)
            r.failovers = (r.failovers or 0) + 1
            if r.failovers > self.max_failovers:
                r.state = RequestState.FAILED
                r.drop_reason = "failover-budget"
                r.finish_time = now
                self.dropped.append(r)
            else:
                r.state = RequestState.WAITING
                r.route_after = (now + self.failover_backoff_s
                                 * 2 ** (r.failovers - 1))
                self._retry.append(r)
        self._retry.sort(key=lambda r: (r.route_after, r.req_id))
        if self.on_replica_down is not None:
            self.on_replica_down(self, idx)

    def schedule_restart(self, idx: int, at_event: int) -> None:
        """Restart replica ``idx`` once the global event count reaches
        ``at_event`` (fault schedules call this from ``on_replica_down``).
        The router performs due restarts itself at the top of each event —
        and knows, when every replica is down, whether waiting for one is
        worthwhile."""
        self._restart_at[idx] = at_event

    def restart_replica(self, idx: int) -> None:
        """Rejoin a crashed replica cold: it re-enters the routing pool with
        empty queues and an empty prefix cache, like a fresh replica."""
        if self.healthy[idx]:
            return
        self.replicas[idx].restart()
        self.healthy[idx] = True
        self.restarts[idx] += 1

    def _fire_restarts(self) -> None:
        for idx in [i for i, at in self._restart_at.items()
                    if self.event_count >= at]:
            del self._restart_at[idx]
            self.restart_replica(idx)

    def _reclaim_starved(self) -> None:
        """Routing-aware starvation bound: a waiting request whose replica's
        KV gate has rejected it ``affinity_escape_after`` times *since it
        was routed there* is pulled back and re-dispatched to a different
        replica — trading its warm prefix for actually running. Needs a
        second healthy replica to escape to."""
        if sum(self.healthy) < 2:
            return
        k = self.affinity_escape_after
        for i, core in enumerate(self.replicas):
            if not self.healthy[i]:
                continue
            stuck = [r for r in core.scheduler.waiting
                     if r.gate_rejections
                     - self._rejections_at_route.get(r.req_id, 0) >= k]
            if not stuck:
                continue
            ids = {id(r) for r in stuck}
            core.scheduler.waiting = [w for w in core.scheduler.waiting
                                      if id(w) not in ids]
            for r in stuck:
                core._hash_memo.pop(r.req_id, None)
                self.assignments.pop(r.req_id, None)
                r.prefilled_tokens = 0
                r.prefill_target = None
                self.dispatch(r, exclude=frozenset((i,)))

    # ------------------------------------------------------------ event loop
    def _earliest(self) -> Tuple[Optional[int], float]:
        """The healthy replica to advance next (earliest ``next_event_time``,
        ties to the lowest index) and its event time. Replicas found dead by
        the probe are failed over on the spot. ``(None, inf)`` when no
        healthy replica has work."""
        best, best_t = None, float("inf")
        for i, core in enumerate(self.replicas):
            if not self.healthy[i]:
                continue
            try:
                t = core.next_event_time()
            except ReplicaCrashed:
                self._fail_replica(i)
                continue
            if t < best_t:
                best, best_t = i, t
        return best, best_t

    def _next_replica(self) -> Optional[int]:
        """The replica to advance next; ``None`` when every healthy replica
        is drained."""
        return self._earliest()[0]

    def step(self) -> bool:
        """One global event: fire due restarts, reclaim affinity-starved
        requests, then route the next due arrival or failover retry, or
        advance the earliest healthy replica one serving cycle. Returns
        False when fully drained (or stalled with every replica down and no
        restart scheduled). An arrival is routed only once no healthy
        replica's next event precedes it, so routing probes see replica
        state as of the arrival time; failover retries wait out their
        backoff (``route_after``) under the same rule."""
        self.event_count += 1
        if self.fault_hook is not None:
            self.fault_hook(self)
        if self._restart_at:
            self._fire_restarts()
        if self.affinity_escape_after is not None:
            self._reclaim_starved()
        idx, t_core = self._earliest()
        arr_t = (self._pending[0].arrival_time if self._pending
                 else float("inf"))
        retry_t = self._retry[0].route_after if self._retry else float("inf")
        if ((self._pending or self._retry)
                and min(arr_t, retry_t) <= t_core and any(self.healthy)):
            req = (self._retry.pop(0) if retry_t <= arr_t
                   else self._pending.popleft())
            self.dispatch(req)
            return True
        if idx is None:
            # every healthy replica is drained. If work is stranded behind a
            # scheduled restart, idle this event (the event count is what
            # advances restart deadlines); with no restart coming, stop.
            return bool(self._restart_at
                        and (self._pending or self._retry))
        try:
            self.replicas[idx].tick()
        except ReplicaCrashed:
            self._fail_replica(idx)
        return True

    def run(self, *, max_steps: Optional[int] = None) -> List[Request]:
        """Drive routing + every replica to completion; returns all finished
        requests (sorted by req_id). ``max_steps`` bounds the global event
        count (property tests interleave bounded runs with invariant
        checks)."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.finished

    # --------------------------------------------------------------- results
    @property
    def finished(self) -> List[Request]:
        out = [r for core in self.replicas for r in core.finished]
        out.sort(key=lambda r: r.req_id)
        return out

    @property
    def all_dropped(self) -> List[Request]:
        """Every terminally dropped request: per-replica drops (cancelled /
        shed / rejected) plus router-level failover-budget failures."""
        out = [r for core in self.replicas for r in core.dropped]
        out.extend(self.dropped)
        out.sort(key=lambda r: r.req_id)
        return out

    def report(self, label: Optional[str] = None) -> RouterReport:
        """Aggregate + per-replica metrics for everything finished so far
        (NaN-safe when some replica served nothing). Counter collection
        lives in :meth:`RunCounters.from_router`, the one place that knows
        which router layers were active."""
        return router_report(label or self.policy,
                             [core.finished for core in self.replicas],
                             counters=RunCounters.from_router(self))
