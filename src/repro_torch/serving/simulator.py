"""Discrete-event continuous-batching simulation: ``SimBackend`` + ServingCore.

Drives the *same* ``ServingCore`` step loop (and the same
``repro_torch.core.scheduler.Scheduler``) the real engine uses, against a calibrated
iteration-time model, so 2000-request bursts and arrival-rate sweeps (paper
§IV-D) run in milliseconds on CPU. Semantics match vLLM-style iteration-level
batching:

* each iteration, every running request whose prompt is fully KV-resident
  decodes exactly one token;
* prefill work is folded into the iteration in which it happens (vLLM's
  mixed prefill/decode steps): the core hands this backend chunks, the
  backend accumulates their token count, and the next ``decode`` charges
  ``prefill_per_token_s`` for them. With chunking off a prompt is one chunk
  and this reduces to the historical admit-then-prefill-whole-prompt cost;
  with ``prefill_chunk_tokens`` set, a long prompt spreads its prefill cost
  over many cheap iterations while co-resident decodes keep advancing —
  ``CostModel.iteration_time`` already models exactly this mixed step.
* iteration time = base + per-decoding-seq cost + per-prefill-token cost,
  the standard two-parameter decode-latency model for batched LLM serving.

Because admission goes through the core's KV gate, a simulated run under a
constrained ``kv_blocks`` budget defers admissions exactly like the real
engine does — by default the budget is unbounded, preserving the paper's
memory-unconstrained sweep setup.

Default constants approximate a 7B-class model on an A100 (the paper's
testbed scale): 25 ms base, 0.15 ms per running request per step, 0.5 ms per
prefill token. Absolute values shift all policies equally; the *relative*
policy gaps the paper reports are driven by queueing, not by the constants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from repro_torch.core.predictor.tokenizer import HashTokenizer
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.serving.config import ServingConfig, resolve_config
from repro_torch.serving.core import PrefillChunk, ServingCore, VirtualClock
from repro_torch.serving.kv_cache import BlockAllocator
from repro_torch.serving.metrics import LatencyReport, RunCounters, report
from repro_torch.serving.router import ReplicaRouter


@dataclass(frozen=True)
class CostModel:
    iter_base_s: float = 0.025       # fixed per-iteration cost
    per_seq_s: float = 0.00015       # marginal cost per running sequence
    prefill_per_token_s: float = 0.0005

    def iteration_time(self, batch_size: int, prefill_tokens: int) -> float:
        return (self.iter_base_s + self.per_seq_s * batch_size
                + self.prefill_per_token_s * prefill_tokens)


class SimBackend:
    """Cost-model execution: prefill records the chunked-in tokens, decode
    charges one mixed iteration and advances every prompt-resident request."""

    # same stable word-hash scheme the real engine's HashTokenizer uses, so
    # textually shared prompt prefixes map to shared token-id prefixes in
    # both execution modes (cross-backend prefix-hit equivalence is tested)
    _TOK = HashTokenizer(vocab_size=2048, max_len=1 << 30)

    def __init__(self, cost: CostModel = CostModel()) -> None:
        self.cost = cost
        self._prefill_tokens = 0
        self.core: Optional[ServingCore] = None

    def attach(self, core: ServingCore) -> None:
        self.core = core

    def kv_demand(self, req: Request) -> int:
        # forced-length protocol: residency is prompt + full completion
        return req.prompt_len + req.true_length

    def prefill_total(self, req: Request) -> int:
        # recompute semantics: a request re-admitted after preemption — or
        # re-dispatched after a replica crash (failover) — re-prefills its
        # prompt plus everything it had already generated
        recompute = req.preempt_count or (req.failovers or 0)
        return req.prompt_len + (req.tokens_done if recompute else 0)

    def prefix_tokens(self, req: Request) -> Sequence[int]:
        """Prefix-sharing stream: the prompt's word-hash ids, truncated to
        the request's declared ``prompt_len`` (the unit the simulator
        charges prefill in). Prompts with fewer words than ``prompt_len``
        can only share up to their word count — the synthetic tail is not
        content, so it is never cached."""
        return self._TOK.encode(req.prompt)[:req.prompt_len]

    def prefill(self, chunks: Sequence[PrefillChunk], now: float) -> float:
        # cost is charged by the decode phase of the same mixed iteration
        self._prefill_tokens += sum(end - start for _r, start, end in chunks)
        return now

    def decode(self, now: float) -> float:
        running = self.core.scheduler.running
        ready = [r for r in running if self.core.decode_ready(r)]
        if not ready and not self._prefill_tokens:
            return now                # nothing resident and nothing chunked
        now += self.cost.iteration_time(len(ready), self._prefill_tokens)
        self._prefill_tokens = 0
        for r in ready:
            r.tokens_done += 1
            if r.first_token_time is None:
                r.first_token_time = now
            if self.core.record_token_times:
                r.token_times.append(now)
        return now

    def release(self, req: Request) -> None:
        pass                          # no slot residency to free


def clone_requests(requests: Sequence[Request]) -> List[Request]:
    """Fresh lifecycle records for re-running one workload under another
    policy: workload identity (prompt, lengths, arrival, deadline,
    tenant/class/SLO annotations) carries over; run state (timestamps,
    scores, queue flags) resets."""
    return [Request(r.req_id, r.prompt, r.arrival_time, r.prompt_len,
                    r.true_length, deadline=r.deadline, tenant=r.tenant,
                    priority_class=r.priority_class, priority=r.priority,
                    slo_ttft_s=r.slo_ttft_s, slo_itl_s=r.slo_itl_s)
            for r in requests]


def make_sim_core(scheduler: Scheduler, *, cost: CostModel = CostModel(),
                  kv_blocks: Optional[int] = None, block_size: int = 16,
                  config: Optional[ServingConfig] = None,
                  **core_kw) -> ServingCore:
    """One fresh simulated serving core: its own allocator (``kv_blocks``
    bounded, or unbounded), ``SimBackend`` and ``VirtualClock``. Behaviour
    comes from ``config`` (or equivalently loose core keywords — chunking,
    caching, reservation mode, re-ranking cadence, deadlines, shedding, …,
    folded into a :class:`ServingConfig` here) — one construction path for
    every sim entry point, so new core features never need plumbing here
    again."""
    allocator = (BlockAllocator(kv_blocks, block_size) if kv_blocks
                 else BlockAllocator.unbounded(block_size))
    return ServingCore(scheduler, SimBackend(cost), allocator=allocator,
                       clock=VirtualClock(),
                       config=resolve_config(config, core_kw))


def simulate(requests: Sequence[Request], scheduler: Scheduler, *,
             cost: CostModel = CostModel(), max_time: float = 1e7,
             kv_blocks: Optional[int] = None, block_size: int = 16,
             faults=None, on_step=None, **core_kw) -> List[Request]:
    """Run to completion; returns the finished requests (with timestamps).
    Terminally dropped requests (deadline cancels, shed, rejected) are NOT
    in the return — single-core callers that enable those features should
    build the core via :func:`make_sim_core` and read ``core.dropped``.

    ``kv_blocks`` bounds the KV cache (in ``block_size``-token blocks);
    ``None`` keeps the historical memory-unbounded behaviour.
    Every extra keyword forwards to ``ServingCore``: notably
    ``prefill_chunk_tokens`` (mixed prefill/decode iterations),
    ``prefix_caching`` (share KV blocks across common prompt prefixes — a
    cache-hit admission only charges the non-shared suffix),
    ``kv_reservation="incremental"`` (admit on prompt + one decode block,
    grow per step), ``rerank_interval`` / ``rerank_every_steps``
    (iterative re-ranking), and the fault-tolerance knobs
    (``deadline_time_per_token``, ``shed_queue_depth``, …).
    ``faults`` — a :class:`~repro_torch.serving.faults.FaultSchedule` to attach
    (arrival skew applied to ``requests`` in place, per-step faults hooked
    onto the core)."""
    core = make_sim_core(scheduler, cost=cost, kv_blocks=kv_blocks,
                         block_size=block_size, **core_kw)
    if faults is not None:
        faults.skew_arrivals(requests)
        faults.attach_core(core)
    core.submit(requests)
    return core.run(max_time=max_time, on_step=on_step)


def make_sim_replicas(n: int, policy_factory: Callable[[], object], *,
                      cost: CostModel = CostModel(),
                      kv_blocks: Optional[int] = None, block_size: int = 16,
                      max_batch: int = 16,
                      starvation_threshold: float = 120.0,
                      preemption: bool = False,
                      **core_kw) -> List[ServingCore]:
    """N independent sim replicas: each gets a fresh scheduler (via
    ``policy_factory`` — a zero-arg callable so stateful scorers are not
    accidentally shared), its own ``kv_blocks``-bounded allocator, its own
    ``SimBackend`` and ``VirtualClock``. Replicas share *nothing*; the
    router is the only thing that sees them together. Extra keywords
    forward to each ``ServingCore`` (chunking, caching, re-ranking,
    deadlines, shedding, …)."""
    cores = []
    for _ in range(n):
        sched = Scheduler(policy=policy_factory(), max_batch=max_batch,
                          starvation_threshold=starvation_threshold,
                          preemption=preemption)
        cores.append(make_sim_core(sched, cost=cost, kv_blocks=kv_blocks,
                                   block_size=block_size, **core_kw))
    return cores


def simulate_replicas(requests: Sequence[Request], *, n_replicas: int,
                      policy_factory: Callable[[], object],
                      routing: str = "round_robin",
                      predicted_len=None, seed: int = 0,
                      max_failovers: int = 3,
                      failover_backoff_s: float = 0.5,
                      affinity_escape_after: Optional[int] = None,
                      faults=None,
                      **replica_kw) -> ReplicaRouter:
    """Multi-replica discrete-event run: build ``n_replicas`` fresh sim
    replicas (``replica_kw`` forwards to :func:`make_sim_replicas`), route
    ``requests`` across them with the ``routing`` policy, and drive
    everything to completion. Returns the router — finished requests,
    per-request ``assignments``, ``all_dropped``, and ``report()`` live
    there. ``faults`` — a :class:`~repro_torch.serving.faults.FaultSchedule`
    wired onto the router (per-replica crash/grow faults, restart
    scheduling, arrival skew); the failover knobs
    (``max_failovers`` / ``failover_backoff_s`` / ``affinity_escape_after``)
    forward to :class:`~repro_torch.serving.router.ReplicaRouter`. Costs scale
    with total tokens, not wall time, so ~10^5-request traces sweep all
    routing policies in seconds-to-minutes on CPU."""
    router = ReplicaRouter(make_sim_replicas(n_replicas, policy_factory,
                                             **replica_kw),
                           policy=routing, predicted_len=predicted_len,
                           seed=seed, max_failovers=max_failovers,
                           failover_backoff_s=failover_backoff_s,
                           affinity_escape_after=affinity_escape_after)
    if faults is not None:
        faults.skew_arrivals(requests)
        faults.attach_router(router)
    router.submit(requests)
    router.run()
    return router


def run_policy(requests: Sequence[Request], policy, *, max_batch: int = 16,
               continuous: bool = True, cost: CostModel = CostModel(),
               starvation_threshold: float = 120.0,
               preemption: bool = False, max_preemptions: int = 2,
               kv_blocks: Optional[int] = None,
               config: Optional[ServingConfig] = None,
               rerank_interval: Optional[float] = None,
               rerank_every_steps: Optional[int] = None,
               **core_kw) -> LatencyReport:
    """Convenience: fresh scheduler + simulate + report. Core behaviour
    comes from ``config`` or loose keywords (chunking, caching, reservation
    mode, deadlines, shedding); a fault-configured run's dropped requests
    are counted in the report, never silently lost (conservation is
    asserted)."""
    if config is None:
        config = ServingConfig.from_kwargs(rerank_interval=rerank_interval,
                                           rerank_every_steps=
                                           rerank_every_steps, **core_kw)
    elif (core_kw or rerank_interval is not None
          or rerank_every_steps is not None):
        raise TypeError("pass either config=ServingConfig(...) or loose "
                        "core keywords, not both")
    # deep-ish copy so one policy run doesn't pollute another (deadlines and
    # class/SLO annotations carry over — they are workload, not run state)
    reqs = clone_requests(requests)
    sched = Scheduler(policy=policy, max_batch=max_batch,
                      continuous=continuous,
                      starvation_threshold=starvation_threshold,
                      preemption=preemption, max_preemptions=max_preemptions)
    core = make_sim_core(sched, cost=cost, kv_blocks=kv_blocks, config=config)
    core.submit(reqs)
    finished = core.run()
    assert len(finished) + len(core.dropped) == len(requests), \
        (len(finished), len(core.dropped), len(requests))
    return report(policy.name, finished,
                  counters=RunCounters(
                      reranks=(sched.rerank_count if config.rerank_enabled
                               else None),
                      dropped=tuple(core.dropped) if core.dropped else None))
