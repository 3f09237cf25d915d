"""ServingConfig: the one frozen record of a serving core's behaviour knobs.

``ServingCore`` grew one keyword argument per feature PR — chunking, prefix
caching, reservation mode, four re-ranking knobs, deadline and shedding
thresholds — until constructing a core meant threading sixteen loose kwargs
through every helper (``make_sim_core``, ``simulate``, ``Engine``, the
benchmarks), with the validation rules duplicated wherever someone built one
by hand. :class:`ServingConfig` consolidates them:

* **frozen** — a config is a value. Two runs built from the same config are
  the same run; benchmarks put the config itself in their JSON output and a
  diff of configs is a diff of behaviours.
* **validated once** — every rule that used to live in
  ``ServingCore.__init__`` lives in :meth:`__post_init__`, so an invalid
  combination fails at config construction, before any scheduler or backend
  exists.
* **round-trippable** — :meth:`to_kwargs` / :meth:`from_kwargs` convert to
  and from the historical keyword form bit-exactly (pinned by tests), which
  is what the legacy-kwargs deprecation shim on ``ServingCore`` uses.

Construction objects (the scheduler, backend, allocator, clock) are *wiring*,
not configuration — they stay direct constructor arguments.

    core = ServingCore(scheduler, backend,
                       config=ServingConfig(prefill_chunk_tokens=256,
                                            prefix_caching=True))

The legacy form ``ServingCore(scheduler, backend, prefix_caching=True, ...)``
still works for one release and emits a :class:`DeprecationWarning`; the
blessed helpers (``make_sim_core`` / ``simulate`` / ``Engine``) translate
loose kwargs into a config internally without the warning.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

#: Reservation modes the admission gate understands (see ServingCore docs).
KV_RESERVATION_MODES = ("full", "incremental")


@dataclass(frozen=True)
class ServingConfig:
    """Behavioural configuration of one :class:`~repro_torch.serving.core.ServingCore`.

    Every field defaults to the historical off/feature-disabled value, so
    ``ServingConfig()`` is exactly the pre-config core: unchunked prefill,
    no caching, full reservation, write-once ranks, no deadlines, no
    shedding.
    """

    # -- chunked prefill ----------------------------------------------------
    #: Per-step prompt-token budget for mixed prefill/decode steps; ``None``
    #: prefills each admitted request to completion in its admission step.
    prefill_chunk_tokens: Optional[int] = None
    #: Record a per-token timestamp on ``Request.token_times`` (enables
    #: gap-based ITL percentiles and per-request ITL SLO attainment).
    record_token_times: bool = False
    # -- prefix caching -----------------------------------------------------
    #: Share KV blocks between requests whose prompts share a leading run of
    #: whole blocks (refcounted, commit-gated — see kv_cache).
    prefix_caching: bool = False
    # -- KV reservation -----------------------------------------------------
    #: ``"full"`` reserves worst-case demand at admission; ``"incremental"``
    #: admits on prompt + one block and grows per decode step.
    kv_reservation: str = "full"
    # -- iterative re-ranking ----------------------------------------------
    #: Refresh priority keys to predicted *remaining* length every this many
    #: clock seconds (``None`` = no time cadence).
    rerank_interval: Optional[float] = None
    #: ... and/or every this many serving cycles (``None`` = no step cadence).
    rerank_every_steps: Optional[int] = None
    #: Lower bound on a refreshed remaining-length key.
    rerank_floor: float = 0.0
    #: Starvation bound: pin a request boosted after this many demotions.
    rerank_pin_after: int = 3
    # -- deadlines ----------------------------------------------------------
    #: Predicted seconds per output token; with it set, a waiting request
    #: whose predicted service time overruns its deadline is cancelled at
    #: admission instead of wasting prefill.
    deadline_time_per_token: Optional[float] = None
    # -- load shedding ------------------------------------------------------
    #: Queue-depth overload threshold (``None`` = queue depth never sheds).
    shed_queue_depth: Optional[int] = None
    #: KV-pressure overload threshold in [0, 1] (``None`` = never).
    shed_kv_pressure: Optional[float] = None
    #: Consecutive over-threshold steps before shedding activates.
    shed_sustain_steps: int = 3
    #: While shedding is active, refuse admission to work predicted longer
    #: than this many tokens (high-priority classes are exempt — see core).
    shed_predicted_tokens: Optional[float] = None

    def __post_init__(self) -> None:
        if (self.prefill_chunk_tokens is not None
                and self.prefill_chunk_tokens <= 0):
            raise ValueError("prefill_chunk_tokens must be positive or None")
        if self.kv_reservation not in KV_RESERVATION_MODES:
            raise ValueError(f"kv_reservation must be one of "
                             f"{KV_RESERVATION_MODES}, "
                             f"got {self.kv_reservation!r}")
        if self.rerank_interval is not None and self.rerank_interval <= 0:
            raise ValueError("rerank_interval must be positive or None")
        if (self.rerank_every_steps is not None
                and self.rerank_every_steps <= 0):
            raise ValueError("rerank_every_steps must be positive or None")
        if self.rerank_pin_after < 0:
            raise ValueError("rerank_pin_after must be >= 0")
        if (self.deadline_time_per_token is not None
                and self.deadline_time_per_token < 0):
            raise ValueError("deadline_time_per_token must be >= 0 or None")
        if self.shed_queue_depth is not None and self.shed_queue_depth < 0:
            raise ValueError("shed_queue_depth must be >= 0 or None")
        if (self.shed_kv_pressure is not None
                and not 0.0 <= self.shed_kv_pressure <= 1.0):
            raise ValueError("shed_kv_pressure must be in [0, 1] or None")
        if self.shed_sustain_steps < 1:
            raise ValueError("shed_sustain_steps must be >= 1")
        if (self.shed_predicted_tokens is not None
                and self.shed_predicted_tokens <= 0):
            raise ValueError("shed_predicted_tokens must be positive or None")

    # ------------------------------------------------------------- derived
    @property
    def rerank_enabled(self) -> bool:
        return (self.rerank_interval is not None
                or self.rerank_every_steps is not None)

    @property
    def shed_enabled(self) -> bool:
        return (self.shed_queue_depth is not None
                or self.shed_kv_pressure is not None)

    # ---------------------------------------------------------- conversion
    @classmethod
    def field_names(cls) -> tuple:
        return tuple(f.name for f in dataclasses.fields(cls))

    @classmethod
    def from_kwargs(cls, **kwargs) -> "ServingConfig":
        """Build from the historical loose-kwargs form; unknown names raise
        ``TypeError`` with the offending keys (the shim's error message)."""
        unknown = set(kwargs) - set(cls.field_names())
        if unknown:
            raise TypeError(f"unknown ServingConfig field(s): "
                            f"{sorted(unknown)}; valid fields are "
                            f"{list(cls.field_names())}")
        return cls(**kwargs)

    def to_kwargs(self) -> dict:
        """The loose-kwargs form, bit-exact round trip with
        :meth:`from_kwargs` (``from_kwargs(**cfg.to_kwargs()) == cfg``)."""
        return dataclasses.asdict(self)

    def replace(self, **changes) -> "ServingConfig":
        """A copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)


def resolve_config(config: Optional[ServingConfig],
                   core_kw: dict) -> ServingConfig:
    """The helper-level construction contract shared by ``make_sim_core`` /
    ``simulate`` / ``Engine`` / ``serve``: either an explicit
    ``config=ServingConfig(...)`` or loose core keywords (translated through
    :meth:`ServingConfig.from_kwargs` — same validation, no deprecation
    warning, since the helpers are a blessed construction path), never
    both."""
    if config is None:
        return ServingConfig.from_kwargs(**core_kw)
    if core_kw:
        raise TypeError(f"pass either config=ServingConfig(...) or loose "
                        f"core keywords, not both (got config= and "
                        f"{sorted(core_kw)})")
    return config
