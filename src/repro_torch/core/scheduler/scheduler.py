"""Predictor-guided continuous-batching scheduler (paper §III-B).

vLLM-style two-queue structure:

* **Waiting queue (W)** — arrived, not yet executing. Re-ranked every
  scheduling cycle by the policy's priority key (ascending).
* **Running queue (R)** — currently in the engine's batch, capacity
  ``max_batch``. Under continuous batching, finished requests are replaced
  at iteration granularity; under static batching a whole batch must drain
  before W is consulted again.

Starvation prevention (paper default 2 minutes): any waiting request whose
wait time exceeds ``starvation_threshold`` has its priority boosted — boosted
requests are scheduled ahead of everything else, FIFO among themselves.

**Iterative re-ranking** (:meth:`Scheduler.rerank`, driven by the serving
core's ``rerank_interval``): refresh every request's priority key to its
predicted *remaining* length through the policy's batched
:meth:`~repro_torch.core.scheduler.policies.Policy.refresh`. The next scheduling
cycle's sort, admission order, and preemption victim choice all read the
refreshed keys — a long request that has nearly finished stops ranking as
"long". Because refreshed ranks can demote a request repeatedly, re-ranked
runs carry a starvation bound: a request preempted or deferred more than
``pin_after_demotions`` times is pinned boosted (scheduled ahead of all
ranked traffic, never preempted again).

This object is shared verbatim by the real JAX engine and the discrete-event
simulator; only the clock source differs.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.core.scheduler.policies import Policy
from repro_torch.core.scheduler.request import Request, RequestState

DEFAULT_STARVATION_S = 120.0


@dataclass
class Scheduler:
    policy: Policy
    max_batch: int = 16
    starvation_threshold: float = DEFAULT_STARVATION_S
    continuous: bool = True            # False = static batching
    # vLLM-style recompute preemption (beyond-paper, off by default): when R
    # is full and a waiting request's priority key undercuts a running one by
    # more than ``preempt_margin``, the worst running request is evicted back
    # to W (losing its KV cache — on re-admission it re-prefills prompt +
    # already-generated tokens, which the simulator charges). Bounded per
    # request by ``max_preemptions`` to prevent thrash; boosted requests are
    # never preempted.
    preemption: bool = False
    preempt_margin: float = 0.0
    max_preemptions: int = 2
    # Starvation bound for refreshed ranks: once a request has been demoted
    # (preempted or deferred) more than this many times, it is pinned
    # boosted. ``None`` disables the bound (the historical behaviour); the
    # serving core sets it whenever iterative re-ranking is enabled.
    pin_after_demotions: Optional[int] = None
    # KV-budget awareness (installed by ServingCore): ``admit_hook`` is the
    # admission gate — called in rank order, it reserves cache blocks and
    # returns False to keep a request in W this cycle (memory back-pressure
    # without queue surgery). ``evict_hook`` releases a preemption victim's
    # reservation and backend residency. Both are optional so the scheduler
    # stays usable standalone in unit tests.
    admit_hook: Optional[Callable[[Request], bool]] = None
    evict_hook: Optional[Callable[[Request], None]] = None
    waiting: List[Request] = field(default_factory=list)
    running: List[Request] = field(default_factory=list)
    # observability: rank passes (full sorts of W) and re-rank refreshes —
    # the double-rank regression test counts the former per cycle
    rank_passes: int = 0
    rerank_count: int = 0
    # a refresh happened and no ranked cycle has consumed it yet: preemptions
    # in that first cycle are attributed to re-ranking (metrics)
    _just_reranked: bool = field(default=False, init=False, repr=False)

    # ------------------------------------------------------------------ API
    def add_request(self, req: Request) -> None:
        self.policy.annotate([req])
        req.state = RequestState.WAITING
        self.waiting.append(req)

    def add_requests(self, reqs: List[Request]) -> None:
        self.policy.annotate(reqs)
        for r in reqs:
            r.state = RequestState.WAITING
        self.waiting.extend(reqs)

    def rerank(self, now: float, *, floor: float = 0.0) -> int:
        """Refresh every queued request's priority key to its predicted
        remaining length (one batched scorer call for W — see
        ``Policy.refresh``). The following :meth:`schedule` cycle sorts,
        admits, and preempts by the refreshed keys. Returns the number of
        refreshed keys (0 for policies with no length estimate)."""
        n = self.policy.refresh(self.running, self.waiting, floor=floor)
        self.rerank_count += 1
        self._just_reranked = True
        return n

    def _boost(self, now: float) -> None:
        for r in self.waiting:
            if not r.boosted and now - r.arrival_time > self.starvation_threshold:
                r.boosted = True

    def _sort_key(self, r: Request) -> Tuple:
        """W ordering: boosted first (FIFO among them), then policy key,
        then arrival (stable tiebreak)."""
        return ((0, r.arrival_time, 0.0) if r.boosted
                else (1, self.policy.key(r), r.arrival_time))

    def _rank(self) -> None:
        self.waiting.sort(key=self._sort_key)
        self.rank_passes += 1

    def _note_demotion(self, r: Request) -> None:
        """Starvation bound under re-ranking: a request demoted (preempted
        or deferred) more than ``pin_after_demotions`` times is pinned
        boosted — ahead of all ranked traffic, never preempted again."""
        if (self.pin_after_demotions is not None
                and r.preempt_count + r.defer_count > self.pin_after_demotions):
            r.boosted = True

    def schedule(self, now: float) -> List[Request]:
        """One scheduling cycle: move top-ranked W → R up to capacity.

        Returns the newly admitted requests (engine must prefill them).
        Under static batching, admission only happens when R is empty.
        W is boosted and ranked exactly once per cycle; the preemption pass
        and the admission scan both reuse that one sort (victims evicted
        mid-cycle are inserted in rank order, not re-sorted).
        """
        self.retire_finished(now)
        if not self.continuous and self.running:
            return []
        free = self.max_batch - len(self.running)
        if not self.waiting or (free <= 0 and not self.preemption):
            return []
        # Predictor fault recovery: while a scorer dispatch has failed and
        # left waiting requests unscored (or the policy sits degraded), offer
        # the queue back for scoring each cycle. A healthy run never sets
        # ``needs_rescore``, so this line is dead on the fault-free path.
        if self.policy.needs_rescore:
            self.policy.rescore(self.waiting)
        self._boost(now)
        self._rank()
        if self.preemption:
            self._preempt()
            free = self.max_batch - len(self.running)
        self._just_reranked = False
        if free <= 0 or not self.waiting:
            return []
        if self.admit_hook is None:
            admitted = self.waiting[:free]
            del self.waiting[:free]
        else:
            admitted, kept = [], []
            for i, r in enumerate(self.waiting):
                if len(admitted) == free:
                    kept.extend(self.waiting[i:])
                    break
                (admitted if self.admit_hook(r) else kept).append(r)
            self.waiting = kept
        for r in admitted:
            r.state = RequestState.RUNNING
            r.start_time = now
        self.running.extend(admitted)
        return admitted

    def add_admit_gate(self, gate: Callable[[Request], bool]) -> None:
        """Compose an extra admission predicate with the installed
        ``admit_hook``. Admission then requires every gate *and* the base
        hook to accept; a gate returning False keeps the request in W this
        cycle, exactly like the hook itself. Gates added later run FIRST —
        cheap predicates evaluate before the serving core's hook reserves
        KV blocks, so a gate rejection can never leak a reservation. This
        is how a front-end above the core (the multi-replica router) vetoes
        or observes per-replica admissions through the same admission path
        instead of inventing a second gate mechanism."""
        base = self.admit_hook
        if base is None:
            self.admit_hook = gate
        else:
            def chained(r: Request, _gate=gate, _base=base) -> bool:
                return _gate(r) and _base(r)
            self.admit_hook = chained

    def defer(self, reqs: List[Request]) -> None:
        """Return admitted-but-unplaceable requests to the head of W (engine
        back-pressure through the scheduler API, not queue surgery). The
        caller is responsible for releasing any resources it reserved.

        Membership is by request *identity* (an id-set, O(n+m)): two
        field-identical requests must never be confused, and a linear
        ``r in reqs`` scan per running request was O(n·m)."""
        if not reqs:
            return
        ids = {id(r) for r in reqs}
        self.running = [r for r in self.running if id(r) not in ids]
        for r in reqs:
            r.state = RequestState.WAITING
            r.prefilled_tokens = 0       # deferred residency is fully released
            r.prefill_target = None
            r.defer_count += 1
            self._note_demotion(r)
        self.waiting[:0] = reqs

    def _preempt(self) -> None:
        """Evict worst-running in favour of strictly-better waiting requests
        (requires self.waiting already ranked; keeps it ranked)."""
        while len(self.running) >= self.max_batch and self.waiting:
            cand = self.waiting[0]
            # boosted requests are never preempted (the starvation bound's
            # "pinned" guarantee), whatever the candidate's key says
            victim_pool = [r for r in self.running if not r.boosted]
            victims = [r for r in victim_pool
                       if r.preempt_count < self.max_preemptions]
            if not victims:
                return
            victim = max(victims, key=self.policy.key)
            if (cand.boosted and not victim.boosted) or (
                    self.policy.key(cand) + self.preempt_margin
                    < self.policy.key(victim)):
                self.running.remove(victim)
                victim.state = RequestState.WAITING
                victim.preempt_count += 1
                if getattr(self, "_just_reranked", False):
                    victim.rerank_preemptions = \
                        (victim.rerank_preemptions or 0) + 1
                self._note_demotion(victim)
                # a half-prefilled victim loses its partial KV residency too:
                # re-admission re-prefills from offset 0 (recompute semantics)
                # and re-snapshots its prefill target
                victim.prefilled_tokens = 0
                victim.prefill_target = None
                if self.evict_hook is not None:
                    self.evict_hook(victim)
                # W stays sorted: insert at the victim's rank position
                # instead of re-sorting the whole queue
                bisect.insort(self.waiting, victim, key=self._sort_key)
            else:
                return

    def retire_finished(self, now: float) -> List[Request]:
        done = [r for r in self.running if r.finished]
        for r in done:
            r.state = RequestState.FINISHED
            if r.finish_time is None:
                r.finish_time = now
        self.running = [r for r in self.running if not r.finished]
        return done

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
