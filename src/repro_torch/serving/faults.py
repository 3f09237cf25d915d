"""Deterministic fault injection for the serving stack.

Production prediction-based schedulers treat component failure as a
first-class input — ELIS's iterative scheduler tolerates stale or broken
estimates, and proxy-model serving degrades to FCFS when the proxy is
unavailable. This module makes failure *injectable, seeded, and observable*
for this repo's serving stack: a :class:`FaultSchedule` describes exactly
which faults fire when, and attaches itself to the existing extension
points — the serving core's per-step ``fault_hook``, the router's per-event
``fault_hook`` / ``on_replica_down`` callbacks, and a wrapped scorer
callable — so the hot path carries **no testing branches**: a run with no
schedule attached executes byte-for-byte the same instructions as before
this module existed.

Fault kinds (all deterministic under a fixed schedule):

* **Replica crash / restart** (:class:`ReplicaCrash`) — the replica's
  serving core raises :class:`ReplicaCrashed` at its own step ``at_step``;
  the router detects the dead replica (tick or probe failure), marks it
  unhealthy, and fails its in-flight requests over to healthy replicas
  (their KV is lost — recompute-from-prompt, bounded retries, exponential
  backoff). ``down_events`` router events later the replica restarts and
  rejoins the routing pool cold.
* **Scorer faults** (:class:`ScorerOutage`) — the wrapped scorer raises
  :class:`ScorerError` (or :class:`ScorerTimeout`) on scheduled batched
  dispatches; the policy's failure budget then degrades ranking to FCFS
  until the scorer heals (see ``Policy`` in
  :mod:`repro_torch.core.scheduler.policies`).
* **KV grow-failure storms** (:class:`GrowStorm`) — ``allocator.grow``
  returns ``False`` for every call inside a step window, exercising the
  core's grow-denial preemption / self-deferral ladder under pressure that
  real fragmentation or concurrent growth would cause.
* **Clock-skewed arrivals** (:meth:`FaultSchedule.skew_arrivals`) — seeded
  bounded jitter on arrival timestamps, modelling skewed front-end clocks.

Use :meth:`FaultSchedule.chaos` to generate a randomized-but-seeded
schedule, or construct the event tuples explicitly for pinpoint tests.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class ReplicaCrashed(RuntimeError):
    """A serving-core replica died: raised by the fault hook at the
    scheduled step, and by every probe/tick on a core whose ``inject_crash``
    flag is set — the router treats any of these as replica death."""


class ScorerError(RuntimeError):
    """Injected scorer dispatch failure (the predictor process died,
    returned garbage, …)."""


class ScorerTimeout(ScorerError):
    """Injected scorer dispatch timeout (the predictor stalled past the
    policy's deadline). A subclass of :class:`ScorerError`: both count
    against the same failure budget."""


@dataclass(frozen=True)
class ReplicaCrash:
    """Replica ``replica`` crashes when its core reaches step ``at_step``
    (1-based, compared against ``ServingCore.step_count``); ``down_events``
    router events later it restarts cold. ``None`` = never restarts."""
    replica: int
    at_step: int
    down_events: Optional[int] = None


@dataclass(frozen=True)
class ScorerOutage:
    """Batched scorer dispatches ``[first_call, first_call + n_calls)``
    (0-based call index on the *wrapped* scorer) fail with
    :class:`ScorerError`, or :class:`ScorerTimeout` when ``kind`` is
    ``"timeout"``."""
    first_call: int
    n_calls: int
    kind: str = "error"


@dataclass(frozen=True)
class GrowStorm:
    """Every ``allocator.grow`` call on ``replica`` while its core's
    ``step_count`` is in ``[start_step, end_step)`` is denied."""
    replica: int
    start_step: int
    end_step: int


@dataclass(frozen=True)
class ArrivalSkew:
    """Uniform arrival-time jitter in ``[-max_abs_s, +max_abs_s]`` seconds,
    clipped at 0 (no arrivals before the trace origin)."""
    max_abs_s: float


@dataclass
class FaultSchedule:
    """One deterministic plan of injected faults, attached via hooks.

    The schedule is pure data plus attachment methods; it owns injection
    *counters* (``injected_*``) so a chaos run can assert every scheduled
    fault actually fired. Counters are cumulative across attachments —
    call :meth:`reset_counters` between runs that reuse one schedule.
    """
    crashes: Tuple[ReplicaCrash, ...] = ()
    scorer_outages: Tuple[ScorerOutage, ...] = ()
    grow_storms: Tuple[GrowStorm, ...] = ()
    arrival_skew: Optional[ArrivalSkew] = None
    seed: int = 0
    injected_crashes: int = field(default=0, init=False)
    injected_scorer_faults: int = field(default=0, init=False)
    injected_grow_denials: int = field(default=0, init=False)

    # ------------------------------------------------------------- factories
    @classmethod
    def chaos(cls, seed: int, *, n_replicas: int, horizon_steps: int = 200,
              n_crashes: int = 2, restart_events: int = 40,
              n_scorer_outages: int = 1, outage_calls: int = 4,
              n_grow_storms: int = 1, storm_steps: int = 5,
              arrival_skew_s: float = 0.0) -> "FaultSchedule":
        """A randomized-but-seeded schedule: the same ``(seed, kwargs)``
        always produces the same fault plan, so a chaos run is exactly
        reproducible."""
        rng = random.Random(seed)
        crashes = tuple(
            ReplicaCrash(replica=rng.randrange(n_replicas),
                         at_step=rng.randint(2, max(horizon_steps, 3)),
                         down_events=restart_events)
            for _ in range(n_crashes))
        outages = tuple(
            ScorerOutage(first_call=rng.randint(1, 20),
                         n_calls=outage_calls,
                         kind=rng.choice(("error", "timeout")))
            for _ in range(n_scorer_outages))
        storms = []
        for _ in range(n_grow_storms):
            start = rng.randint(2, max(horizon_steps, 3))
            storms.append(GrowStorm(replica=rng.randrange(n_replicas),
                                    start_step=start,
                                    end_step=start + storm_steps))
        skew = ArrivalSkew(arrival_skew_s) if arrival_skew_s > 0 else None
        return cls(crashes=crashes, scorer_outages=outages,
                   grow_storms=tuple(storms), arrival_skew=skew, seed=seed)

    def reset_counters(self) -> None:
        self.injected_crashes = 0
        self.injected_scorer_faults = 0
        self.injected_grow_denials = 0

    # ------------------------------------------------------------ attachment
    def wrap_scorer(self, scorer):
        """A scorer that fails on the scheduled batched-dispatch indices and
        delegates otherwise. Each wrap owns its own call counter, so one
        schedule can wrap many policies (e.g. one per replica) and each
        counts its own dispatches."""
        outages = self.scorer_outages
        state = {"calls": 0}

        def faulty(prompts):
            i = state["calls"]
            state["calls"] += 1
            for o in outages:
                if o.first_call <= i < o.first_call + o.n_calls:
                    self.injected_scorer_faults += 1
                    exc = ScorerTimeout if o.kind == "timeout" else ScorerError
                    raise exc(f"injected scorer {o.kind} on dispatch {i}")
            return scorer(prompts)
        return faulty

    def attach_core(self, core, replica: int = 0) -> None:
        """Install this schedule's per-step faults on one serving core:
        a ``fault_hook`` that raises :class:`ReplicaCrashed` at the
        scheduled crash steps, and a ``grow`` wrapper that denies every
        allocation-growth call inside a storm window. Cores with no
        scheduled faults for ``replica`` are left untouched (their hot path
        stays hook-free)."""
        crash_steps = {c.at_step for c in self.crashes if c.replica == replica}
        storms = [s for s in self.grow_storms if s.replica == replica]
        if crash_steps:
            def hook(c, _now, _steps=crash_steps):
                if c.step_count in _steps:
                    self.injected_crashes += 1
                    raise ReplicaCrashed(
                        f"injected crash at step {c.step_count}")
            core.fault_hook = hook
        if storms:
            orig_grow = core.allocator.grow

            def stormy_grow(req_id, n, _core=core, _storms=storms,
                            _orig=orig_grow):
                if any(s.start_step <= _core.step_count < s.end_step
                       for s in _storms):
                    self.injected_grow_denials += 1
                    return False
                return _orig(req_id, n)
            core.allocator.grow = stormy_grow

    def attach_router(self, router) -> None:
        """Wire the whole schedule onto a multi-replica router: per-replica
        core faults, plus restart scheduling — when the router reports a
        replica down (``on_replica_down``), the matching crash's
        ``down_events`` books a restart with the router itself
        (``schedule_restart``), so the router knows a rejoin is coming and
        keeps draining stranded work instead of stalling while every
        replica is down."""
        for i, core in enumerate(router.replicas):
            self.attach_core(core, replica=i)
        down_plan: Dict[int, List[Optional[int]]] = {}
        for c in self.crashes:
            down_plan.setdefault(c.replica, []).append(c.down_events)

        def on_down(rt, idx):
            plan = down_plan.get(idx)
            down = plan.pop(0) if plan else None
            if down is not None:
                rt.schedule_restart(idx, rt.event_count + down)
        router.on_replica_down = on_down

    # --------------------------------------------------------------- arrivals
    def skew_arrivals(self, requests: Sequence) -> None:
        """Apply seeded clock skew to a trace in place (bounded uniform
        jitter per request, clipped at 0), modelling skewed front-end
        clocks. Deterministic: jitter depends only on ``(seed, req_id)``."""
        if self.arrival_skew is None:
            return
        m = self.arrival_skew.max_abs_s
        for r in requests:
            u = random.Random(self.seed * 1_000_003 + r.req_id).uniform(-m, m)
            r.arrival_time = max(0.0, r.arrival_time + u)
