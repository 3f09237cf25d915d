"""Declarative multi-tenant SLO workloads: the traces PARS gets judged on.

Every benchmark before this module hand-rolled its own trace (one Poisson
stream, one bimodal length mix) and reported means. Production schedulers are
judged on something harsher — *per-class SLO attainment and goodput under
bursty multi-tenant load* (SNIPPETS ch. 9; the evaluation setup of learned
re-ranking papers) — so this module generates exactly that, declaratively and
reproducibly:

* **bursty arrivals** — each tenant cycles through :class:`ArrivalPhase`
  segments (rate, duration): Poisson within a phase, on/off burst structure
  across phases. A tenant with ``(quiet, burst)`` phases hammers the queue
  periodically; a steady tenant is one phase.
* **multi-turn conversations** — an arrival starts a conversation; follow-up
  turns re-arrive after a think-time gap with a prompt that *extends* the
  previous turn's prompt (system prefix + accumulated turns + assistant
  echo). Chained block hashes (``prefix_chunk_hashes``) make each turn a
  natural prefix-cache hit on the committed blocks of the turn before it —
  the cache churn pattern real serving sees, not a synthetic duplicate
  stream. Tenants also share a per-tenant system prompt across
  conversations (cross-conversation sharing).
* **reasoning long-tail outputs** — :class:`OutputDist` is a lognormal body
  with an optional ``long_frac`` tail multiplier: most answers are short,
  a few think for thousands of tokens. The tail is what separates
  length-aware scheduling from FCFS.
* **priority classes carrying SLOs** — each conversation draws a
  :class:`PriorityClass` (weighted) whose :class:`SLO` targets (TTFT,
  mean inter-token gap) land on every request of the conversation as
  ``Request.slo_ttft_s`` / ``slo_itl_s``, with ``tenant`` /
  ``priority_class`` / ``priority`` alongside. ``metrics.slo_report``
  scores a run against them; the core's overload shedding reads
  ``priority`` to pick victims.

Determinism: the whole trace is a pure function of the :class:`WorkloadSpec`
(including its seed). Each tenant draws from ``default_rng([seed, tenant
index])``, so adding a tenant never perturbs another tenant's stream, and
regenerating with the same spec is bit-identical (pinned by tests). Replay
the same trace under different policies with
:func:`repro_torch.serving.simulator.clone_requests`.

The prompt-token convention matches the rest of the repo: ``prompt_len`` =
1 (CLS) + word count, the unit both the simulator's cost model and the
prefix-sharing stream (``HashTokenizer`` word hashes) charge in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.scheduler.request import Request


@dataclass(frozen=True)
class SLO:
    """Latency targets one priority class promises. ``None`` = no promise
    on that axis (attainment reports NaN, never a fake 100%)."""
    ttft_s: Optional[float] = None    # arrival → first token
    itl_s: Optional[float] = None     # mean inter-token gap


@dataclass(frozen=True)
class PriorityClass:
    """One request class inside a tenant: its SLO contract, its numeric
    priority (read by overload shedding — higher survives longer), and its
    share of the tenant's conversations (``weight``, normalised over the
    tenant's classes)."""
    name: str
    slo: SLO = SLO()
    priority: int = 0
    weight: float = 1.0


@dataclass(frozen=True)
class OutputDist:
    """Reasoning long-tail output lengths: a lognormal body (median
    ``median_tokens``, log-sigma ``sigma``) where each draw is stretched by
    ``long_scale`` with probability ``long_frac`` — the o1-style "thinks
    for pages" tail. Clamped to [min_tokens, max_tokens]."""
    median_tokens: int = 48
    sigma: float = 0.6
    long_frac: float = 0.0
    long_scale: float = 8.0
    min_tokens: int = 2
    max_tokens: int = 4096

    def __post_init__(self) -> None:
        if self.median_tokens < 1:
            raise ValueError("median_tokens must be >= 1")
        if not 0.0 <= self.long_frac <= 1.0:
            raise ValueError("long_frac must be in [0, 1]")
        if self.min_tokens < 1 or self.max_tokens < self.min_tokens:
            raise ValueError("need 1 <= min_tokens <= max_tokens")

    def sample(self, rng: np.random.Generator) -> int:
        n = self.median_tokens * float(rng.lognormal(0.0, self.sigma))
        if self.long_frac and rng.random() < self.long_frac:
            n *= self.long_scale
        return int(np.clip(round(n), self.min_tokens, self.max_tokens))


@dataclass(frozen=True)
class ArrivalPhase:
    """One segment of a tenant's on/off arrival cycle: Poisson at
    ``rate_per_s`` for ``duration_s`` seconds. ``rate_per_s=0`` is a quiet
    phase. Tenants cycle their phase tuple until the workload window ends."""
    rate_per_s: float
    duration_s: float

    def __post_init__(self) -> None:
        if self.rate_per_s < 0:
            raise ValueError("rate_per_s must be >= 0")
        if self.duration_s <= 0:
            raise ValueError("duration_s must be positive")


@dataclass(frozen=True)
class ConversationSpec:
    """Multi-turn structure: after each turn the conversation continues
    with probability ``p_continue`` (capped at ``max_turns``), re-arriving
    after an exponential think-time gap (mean ``think_time_s``). Each turn
    appends ``turn_words`` fresh user words plus an assistant echo of up to
    ``echo_cap_words`` words per generated token of the previous answer, on
    top of the tenant's ``system_words``-word shared system prompt."""
    max_turns: int = 1
    p_continue: float = 0.0
    think_time_s: float = 2.0
    turn_words: int = 12
    echo_cap_words: int = 48

    def __post_init__(self) -> None:
        if self.max_turns < 1:
            raise ValueError("max_turns must be >= 1")
        if not 0.0 <= self.p_continue <= 1.0:
            raise ValueError("p_continue must be in [0, 1]")
        if self.think_time_s < 0:
            raise ValueError("think_time_s must be >= 0")
        if self.turn_words < 1:
            raise ValueError("turn_words must be >= 1")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: its burst cycle, class mix, output distribution,
    conversation shape, and shared system-prompt length."""
    name: str
    phases: Tuple[ArrivalPhase, ...]
    classes: Tuple[PriorityClass, ...] = (PriorityClass("default"),)
    outputs: OutputDist = OutputDist()
    conversation: ConversationSpec = ConversationSpec()
    system_words: int = 32

    def __post_init__(self) -> None:
        if not self.phases:
            raise ValueError(f"tenant {self.name!r} needs >= 1 arrival phase")
        if not self.classes:
            raise ValueError(f"tenant {self.name!r} needs >= 1 class")
        if any(c.weight < 0 for c in self.classes) \
                or not any(c.weight > 0 for c in self.classes):
            raise ValueError(f"tenant {self.name!r} class weights must be "
                             f">= 0 with at least one > 0")
        if self.system_words < 0:
            raise ValueError("system_words must be >= 0")


@dataclass(frozen=True)
class WorkloadSpec:
    """The whole declarative workload: tenants + window + seed. The trace
    is a pure function of this record."""
    tenants: Tuple[TenantSpec, ...]
    duration_s: float = 60.0
    seed: int = 0

    def __post_init__(self) -> None:
        if not self.tenants:
            raise ValueError("need >= 1 tenant")
        if len({t.name for t in self.tenants}) != len(self.tenants):
            raise ValueError("tenant names must be unique")
        if self.duration_s <= 0:
            raise ValueError("duration_s must be positive")


def _conversation_starts(tenant: TenantSpec, duration_s: float,
                         rng: np.random.Generator) -> List[float]:
    """Poisson-within-phase arrival times over the cycled burst phases."""
    starts: List[float] = []
    t, i = 0.0, 0
    while t < duration_s:
        phase = tenant.phases[i % len(tenant.phases)]
        end = min(t + phase.duration_s, duration_s)
        if phase.rate_per_s > 0:
            tt = t + float(rng.exponential(1.0 / phase.rate_per_s))
            while tt < end:
                starts.append(tt)
                tt += float(rng.exponential(1.0 / phase.rate_per_s))
        t, i = end, i + 1
    return starts


def _pick_class(tenant: TenantSpec,
                rng: np.random.Generator) -> PriorityClass:
    w = np.asarray([c.weight for c in tenant.classes], dtype=float)
    return tenant.classes[int(rng.choice(len(w), p=w / w.sum()))]


def generate_trace(spec: WorkloadSpec) -> List[Request]:
    """The trace: requests sorted by arrival time, ``req_id`` = position.

    Each tenant's stream is drawn from ``default_rng([spec.seed, tenant
    index])`` — independent substreams, so tenants never perturb each
    other and the whole trace is reproducible from the spec alone.
    Conversation turns share a growing textual prefix (system prompt +
    prior turns + assistant echoes), which the prefix cache's chained
    block hashes turn into real hits; ``true_length`` draws from the
    tenant's long-tail output distribution; the conversation's priority
    class stamps tenant/class/priority/SLO annotations on every turn."""
    rows: List[Request] = []
    for ti, tenant in enumerate(spec.tenants):
        rng = np.random.default_rng([spec.seed, ti])
        conv = tenant.conversation
        system = " ".join(f"{tenant.name}s{k}"
                          for k in range(tenant.system_words))
        for ci, t0 in enumerate(_conversation_starts(tenant, spec.duration_s,
                                                     rng)):
            klass = _pick_class(tenant, rng)
            prompt, t = system, t0
            for turn in range(conv.max_turns):
                user = " ".join(f"{tenant.name}c{ci}t{turn}w{j}"
                                for j in range(conv.turn_words))
                prompt = (prompt + " " + user) if prompt else user
                out_len = tenant.outputs.sample(rng)
                n_words = len(prompt.split())
                r = Request(0, prompt, float(t), 1 + n_words, out_len,
                            tenant=tenant.name, priority_class=klass.name,
                            priority=klass.priority,
                            slo_ttft_s=klass.slo.ttft_s,
                            slo_itl_s=klass.slo.itl_s)
                rows.append(r)
                if (turn + 1 >= conv.max_turns
                        or rng.random() >= conv.p_continue):
                    break
                # next turn extends this prompt with the assistant's echo
                # (committed blocks of *this* turn become the next turn's
                # prefix hit) and re-arrives after think time + a service
                # proxy so a follow-up never precedes its own answer
                echo = " ".join(f"{tenant.name}c{ci}a{turn}e{j}"
                                for j in range(min(out_len,
                                                   conv.echo_cap_words)))
                prompt = prompt + " " + echo
                gap = (float(rng.exponential(conv.think_time_s))
                       if conv.think_time_s else 0.0)
                t += 0.02 * out_len + gap
    rows.sort(key=lambda r: (r.arrival_time, r.tenant))
    for i, r in enumerate(rows):
        r.req_id = i
    return rows


def trace_summary(reqs: List[Request]) -> dict:
    """Shape-of-the-trace dict for benchmark JSON output (counts per tenant
    and class, token totals) — enough to eyeball a regenerated trace."""
    per_tenant: dict = {}
    per_class: dict = {}
    for r in reqs:
        per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) + 1
        per_class[r.priority_class] = per_class.get(r.priority_class, 0) + 1
    return dict(
        n_requests=len(reqs),
        prompt_tokens=int(sum(r.prompt_len for r in reqs)),
        output_tokens=int(sum(r.true_length for r in reqs)),
        span_s=(float(reqs[-1].arrival_time - reqs[0].arrival_time)
                if reqs else 0.0),
        per_tenant=per_tenant,
        per_class=per_class,
    )
