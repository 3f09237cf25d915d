"""Scheduling policies (paper §IV): FCFS, Pointwise/Listwise/Oracle SJF, PARS.

Every SJF-family policy is "sort the waiting queue by a score, ascending"
(shorter expected response first); they differ only in the score source:

* ``oracle``    — ground-truth response length (perfect foresight bound)
* ``pars``      — pairwise-margin-trained predictor score
* ``pointwise`` — L1-regression predictor score
* ``listwise``  — ListMLE-trained predictor score
* ``fcfs``      — arrival time (the vLLM default / baseline)

Predictor-backed policies are constructed with a ``RankingPredictor`` (or any
``score(prompts) -> array``) and annotate requests once on arrival — scoring
is O(1) per request at scheduling time (paper: "minimal overhead").

**Annotate vs refresh.** ``annotate`` is the write-once arrival path: score
every not-yet-scored request in one batched scorer call and never touch it
again (idempotent — an explicit ``Request.scored`` flag, not a score-value
sentinel). ``refresh`` is the iterative re-ranking path (ELIS-style, driven
by the serving core's ``rerank_interval``): re-score the *waiting* queue in
one batched call (so an online-updated predictor is picked up with zero
per-request dispatch) and refresh every request's priority key to its
predicted *remaining* length, ``max(estimate − tokens_done, floor)``, stored
in ``Request.remaining_est``. Keys read ``remaining_est`` when it has been
refreshed and fall back to the arrival-time basis otherwise, so a run that
never calls ``refresh`` behaves exactly as the historical write-once ranker.

**Predictor graceful degradation.** A production scorer can die, return
garbage, or stall. Every scorer dispatch therefore goes through
:meth:`Policy._dispatch`, which converts exceptions (and wall-clock
overruns past ``scorer_timeout_s``) into counted failures instead of
crashing the scheduler. Requests in a failed batch stay unscored and rank
*last* (unknown length is treated as long — conservative for SJF) until a
retry scores them; after ``scorer_failure_budget`` consecutive dispatch
failures the policy **degrades to FCFS**: every key becomes the request's
arrival time, exactly the ladder proxy-model serving uses when the proxy is
unavailable. While degraded the policy keeps probing the scorer every
``recovery_probe_every``-th dispatch opportunity and recovers automatically
on the first success (keys revert to predictor ranks the next cycle). Both
transitions are counted (``degradations`` / ``recoveries``) and logged.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from repro_torch.core.scheduler.request import Request

POLICY_NAMES = ("fcfs", "pars", "pars+", "pointwise", "listwise", "oracle")

log = logging.getLogger(__name__)

# Rank basis for a request whose scoring dispatch failed (and the policy is
# not yet degraded): last, behind every scored request — unknown length is
# treated as long. The starvation boost still applies, so it cannot starve.
UNSCORED_KEY = float("inf")


@dataclass
class Policy:
    """Priority-key provider. Lower key = scheduled earlier.

    ``estimate`` maps a request to its predicted *total* output length — the
    basis ``refresh`` turns into a remaining-length key. ``None`` (fcfs)
    means the policy has no length estimate and ``refresh`` leaves its keys
    alone.

    ``scorer_failure_budget`` — consecutive failed scorer dispatches before
    the policy degrades to FCFS keys. ``scorer_timeout_s`` — wall-clock
    budget per dispatch; an overrun counts as a failure (the call's result
    is discarded, exactly as if the caller had timed it out).
    ``recovery_probe_every`` — while degraded, probe the scorer on every
    N-th dispatch opportunity; the first success recovers the policy.
    """
    name: str
    key_fn: Callable[[Request], float]
    scorer: Optional[Callable[[Sequence[str]], "object"]] = None
    estimate: Optional[Callable[[Request], float]] = None
    scorer_failure_budget: int = 3
    scorer_timeout_s: Optional[float] = None
    recovery_probe_every: int = 1
    # degradation state (observable, not configuration)
    degraded: bool = field(default=False, init=False)
    consecutive_failures: int = field(default=0, init=False)
    scorer_failures: int = field(default=0, init=False)
    degradations: int = field(default=0, init=False)
    recoveries: int = field(default=0, init=False)
    _probe_calls: int = field(default=0, init=False, repr=False)
    # a dispatch failed and some requests may still be unscored: the
    # scheduler re-offers the waiting queue via ``rescore`` until clear
    needs_rescore: bool = field(default=False, init=False)

    # ---------------------------------------------------------- fault ladder
    def _dispatch(self, prompts: Sequence[str]):
        """One guarded batched scorer call. Returns the scores, or ``None``
        on failure (exception or wall-clock timeout) — never raises. All
        degradation/recovery bookkeeping lives here, so every dispatch site
        (annotate / refresh / probe) shares one ladder."""
        if self.degraded:
            self._probe_calls += 1
            if self._probe_calls % max(self.recovery_probe_every, 1):
                return None             # not this opportunity: stay degraded
        t0 = time.perf_counter() if self.scorer_timeout_s is not None else 0.0
        try:
            scores = self.scorer(prompts)
        except Exception as e:          # noqa: BLE001 — any scorer fault
            return self._note_failure(repr(e))
        if (self.scorer_timeout_s is not None
                and time.perf_counter() - t0 > self.scorer_timeout_s):
            return self._note_failure(
                f"dispatch exceeded {self.scorer_timeout_s}s")
        self.consecutive_failures = 0
        if self.degraded:
            self.degraded = False
            self.recoveries += 1
            log.warning("policy %s: scorer healed — restoring %s ranking",
                        self.name, self.name)
        return scores

    def _note_failure(self, why: str):
        self.scorer_failures += 1
        self.consecutive_failures += 1
        self.needs_rescore = True
        if (not self.degraded
                and self.consecutive_failures >= self.scorer_failure_budget):
            self.degraded = True
            self.degradations += 1
            log.warning("policy %s: %d consecutive scorer failures (last: "
                        "%s) — degrading to FCFS keys", self.name,
                        self.consecutive_failures, why)
        return None

    def annotate(self, requests: List[Request]) -> None:
        """Attach predictor scores to newly arrived requests (batched).

        Idempotent: only requests never scored before are sent to the
        scorer, tracked by ``Request.scored`` — a legitimate score of
        exactly 0.0 is *not* re-scored on later ``add_requests`` calls.
        A failed dispatch leaves its batch unscored (ranked last) and
        flags ``needs_rescore`` so the scheduler retries next cycle.
        """
        if self.scorer is None:
            return
        todo = [r for r in requests if not r.scored]
        if not todo:
            return
        scores = self._dispatch([r.prompt for r in todo])
        if scores is None:
            return
        for r, s in zip(todo, scores):
            r.score = float(s)
            r.scored = True

    def rescore(self, waiting: Sequence[Request]) -> None:
        """Retry path, called by the scheduler while ``needs_rescore``:
        score every still-unscored waiting request, or — when degraded with
        nothing left to score — probe the scorer with one live prompt so
        recovery does not depend on fresh arrivals."""
        todo = [r for r in waiting if not r.scored]
        if todo:
            self.annotate(todo)
            return
        if self.degraded:
            if waiting:
                self._dispatch([waiting[0].prompt])   # recovery probe
        else:
            self.needs_rescore = False               # everything scored

    def refresh(self, running: Sequence[Request], waiting: Sequence[Request],
                *, floor: float = 0.0) -> int:
        """One iterative re-rank: refresh priority keys to predicted
        *remaining* length.

        Waiting requests are re-scored in a single batched scorer call
        (amortized — never one dispatch per request), then every request in
        both queues gets ``remaining_est = max(estimate − tokens_done,
        floor)``. Running requests are *not* re-scored (their prompt hasn't
        changed; their key shrinks because ``tokens_done`` grew). Returns
        the number of requests whose key was refreshed; 0 for policies with
        no length estimate (fcfs), whose keys never change.

        A failed (or degraded) scorer dispatch skips the re-score: keys are
        still decayed by ``tokens_done`` below — stale-but-decaying ranks,
        exactly ELIS's tolerance for a broken estimator.
        """
        if self.estimate is None:
            return 0
        if self.scorer is not None and waiting:
            scores = self._dispatch([r.prompt for r in waiting])
            if scores is not None:
                for r, s in zip(waiting, scores):
                    r.score = float(s)
                    r.scored = True
        n = 0
        for r in (*running, *waiting):
            r.remaining_est = max(self.estimate(r) - r.tokens_done, floor)
            n += 1
        return n

    def key(self, req: Request) -> float:
        if self.scorer is not None:
            if self.degraded:
                return req.arrival_time          # FCFS fallback, all requests
            if not req.scored and self.needs_rescore:
                # a dispatch failure left this request unscored: rank last
                # (unknown length reads as long) until the retry scores it.
                # Gated on the outstanding-failure flag so hand-scored
                # requests outside the serving flow keep their key_fn rank.
                return UNSCORED_KEY
        return self.key_fn(req)


def fcfs() -> Policy:
    return Policy("fcfs", key_fn=lambda r: r.arrival_time)


def oracle_sjf() -> Policy:
    return Policy("oracle",
                  key_fn=lambda r: (r.remaining_est
                                    if r.remaining_est is not None
                                    else float(r.true_length)),
                  estimate=lambda r: float(r.true_length))


def predictor_sjf(name: str, scorer, **fault_kw) -> Policy:
    """PARS / pointwise / listwise — SJF on predicted score (remaining
    length once refreshed). ``fault_kw`` forwards the degradation knobs
    (``scorer_failure_budget`` / ``scorer_timeout_s`` /
    ``recovery_probe_every``)."""
    return Policy(name,
                  key_fn=lambda r: (r.remaining_est
                                    if r.remaining_est is not None
                                    else r.score),
                  scorer=scorer,
                  estimate=lambda r: r.score,
                  **fault_kw)


def pars_plus(scorer, *, alpha: float = 0.5, score_scale: float = 1.0,
              **fault_kw) -> Policy:
    """Beyond-paper variant: prefill-aware SJF.

    The paper ranks by expected *decode* length only; at long-prompt regimes
    (prefill_32k-class requests) admission also pays a prefill cost ∝
    prompt_len. PARS+ ranks by

        key = score / score_scale + alpha * log1p(prompt_len)

    so two requests with equal expected decode length order by prefill cost.
    ``alpha=0`` reduces exactly to PARS. Under iterative re-ranking the
    decode term becomes the refreshed remaining length; the prefill term is
    a fixed property of the prompt and never decays. Evaluated in
    benchmarks/pars_plus_ablation.py.
    """
    import math

    def key(r: Request) -> float:
        base = r.remaining_est if r.remaining_est is not None else r.score
        return base / score_scale + alpha * math.log1p(r.prompt_len)
    return Policy("pars+", key_fn=key, scorer=scorer,
                  estimate=lambda r: r.score, **fault_kw)


def make_policy(name: str, predictor=None, **kw) -> Policy:
    if name == "fcfs":
        return fcfs()
    if name == "oracle":
        return oracle_sjf()
    if name in ("pars", "pointwise", "listwise", "pars+"):
        assert predictor is not None, f"{name} needs a predictor"
        scorer = predictor.score if hasattr(predictor, "score") else predictor
        if name == "pars+":
            return pars_plus(scorer, **kw)
        return predictor_sjf(name, scorer, **kw)
    raise ValueError(f"unknown policy {name!r}")
