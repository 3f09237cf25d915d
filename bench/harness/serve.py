"""Drive the program's engine through one measured window.

The entry the window drives is the program's own:
``repro_torch.serving.engine.Engine`` under ``Scheduler(policy=make_policy(
"pars", scorer), max_batch=...)``, stepped by ``ServingCore.tick``. The
benchmark wraps, on the instances it built, the calls it needs to watch:
the scorer (host time and requests scored), ``Scheduler.schedule`` (who
was admitted beside whom), ``RealBackend.prefill`` (the chunks of each
dispatch, the real prompt tokens, the first tokens) and ``decode`` (rows
and positions of each step). In a traced run each of those calls is also a
named host range (``record_function``) for the profiler.
"""
from __future__ import annotations

import gc
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench.harness import profile as prof_mod


def program_config(cfg_json: dict):
    """The program's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    fields = dict(cfg_json["model"])
    if fields.get("moe"):
        fields["moe"] = MoEConfig(**fields["moe"])
    if fields.get("ssm"):
        fields["ssm"] = SSMConfig(**fields["ssm"])
    return ModelConfig(**fields)


@dataclass
class Window:
    """What the window left for the metrics and the check."""
    window_s: float
    requests: list                      # the program's Request objects
    # (start, end, decoded rows) of each serving step
    steps: List[Tuple[float, float, int]] = field(default_factory=list)
    tokens_at: List[Tuple[float, int]] = field(default_factory=list)
    prefill_calls: List[List[Tuple[int, int, int]]] = field(
        default_factory=list)
    # (step time, first and end real prompt position) of each chunk
    prefill_tokens: List[Tuple[float, int, int]] = field(
        default_factory=list)
    admissions: List[Tuple[List[int], List[int]]] = field(
        default_factory=list)
    # (step time, each row's position, inside the profiled slice)
    decode_calls: List[Tuple[float, List[int], bool]] = field(
        default_factory=list)
    scorer_s: float = 0.0
    scored: int = 0
    serve_s: float = 0.0
    prefill_s: float = 0.0
    prefix_installs: int = 0
    backlog: int = 0
    drained_by: Dict[int, float] = field(default_factory=dict)
    slice: Optional[prof_mod.Slice] = None
    trace_file: Optional[str] = None
    # (start, end) on the serving clock of each profiler start and stop
    paused: List[Tuple[float, float]] = field(default_factory=list)
    host: Optional["HostMeter"] = None


class HostMeter:
    """What the host did over the window, to tell a slower host from more
    work: the main thread's CPU seconds, each garbage collection, the
    seconds spent in ``schedule``, ``prefill`` and ``decode``, and a fixed
    pure-Python loop timed once a step, whose median is the host's speed
    beside the steps."""

    def __init__(self):
        self.probe: List[float] = []
        self.phase = {"schedule": 0.0, "prefill": 0.0, "decode": 0.0}
        self.gc_n = [0, 0, 0]
        self.gc_s = [0.0, 0.0, 0.0]
        self._gc_t0 = 0.0
        self.cpu_s = self.wall_s = 0.0

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            g = info.get("generation", 0)
            self.gc_n[g] += 1
            self.gc_s[g] += time.perf_counter() - self._gc_t0

    def start(self) -> None:
        self._t0 = (time.perf_counter(), time.thread_time())
        gc.callbacks.append(self._gc)

    def stop(self) -> None:
        gc.callbacks.remove(self._gc)
        self.wall_s = time.perf_counter() - self._t0[0]
        self.cpu_s = time.thread_time() - self._t0[1]

    def tick(self) -> None:
        t0 = time.perf_counter()
        x = 0
        for i in range(2000):
            x += i
        self.probe.append(time.perf_counter() - t0)

    def line(self, steps) -> str:
        walls = np.asarray([b - a for a, b, _ in steps]) * 1e3
        q = (np.percentile(walls, [50, 90]) if len(walls)
             else [float("nan")] * 2)
        return (f"host: {len(walls)} steps, step ms median {q[0]:.2f} "
                f"p90 {q[1]:.2f}; schedule {self.phase['schedule']:.3f} s, "
                f"prefill {self.phase['prefill']:.3f} s, decode "
                f"{self.phase['decode']:.3f} s; main thread cpu "
                f"{self.cpu_s:.3f} s of {self.wall_s:.3f} s; gc "
                f"collections {self.gc_n} taking "
                f"{[round(t, 4) for t in self.gc_s]} s; probe us median "
                f"{1e6 * float(np.median(self.probe or [np.nan])):.2f}")


class Scorer:
    """The scorer handed to ``make_policy``: the predictor's ``score``,
    timed on the host (its result is on the host, so the time includes
    the device's work)."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.seconds = 0.0
        self.scored = 0
        self.span = False

    def __call__(self, prompts):
        t0 = time.perf_counter()
        if self.span:
            with torch.profiler.record_function("ranking.score"):
                out = self.predictor.score(prompts)
        else:
            out = self.predictor.score(prompts)
        self.seconds += time.perf_counter() - t0
        self.scored += len(prompts)
        return out


def build(cfg, params, cfg_json: dict, predictor, device):
    """The engine of a configuration, with the PARS policy over
    ``predictor``. Returns ``(engine, scorer)``."""
    from repro_torch.core.scheduler.policies import make_policy
    from repro_torch.core.scheduler.scheduler import Scheduler
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import BlockAllocator

    e = cfg_json["engine"]
    scorer = Scorer(predictor)
    sched = Scheduler(policy=make_policy("pars", scorer),
                      max_batch=e["max_batch"])
    config = ServingConfig(prefill_chunk_tokens=e.get("prefill_chunk_tokens"),
                           prefix_caching=e.get("prefix_caching", False))
    engine = Engine(cfg, params, sched, cache_len=e["cache_len"],
                    prompt_len=e["prompt_len"],
                    allocator=BlockAllocator(e["kv_blocks"], e["block_size"]),
                    record_tokens=True, config=config, device=device)
    return engine, scorer


def warm_up(engine, cfg_json: dict) -> None:
    """Build the kernels, then serve one prompt of each bucket the cell's
    traffic uses (8 to ``prompt_len`` tokens, powers of two), each for one
    decode step."""
    from repro_torch.core.scheduler.request import Request
    from repro_torch.serving.core import WallClock

    engine.warmup()
    e = cfg_json["engine"]
    reqs, b, i = [], 8, 0
    while b <= e["prompt_len"]:
        words = " ".join(f"warm{i}w{j}" for j in range(b - 1))
        reqs.append(Request(req_id=-1 - i, prompt=words, arrival_time=0.0,
                            prompt_len=b, true_length=2))
        b, i = b * 2, i + 1
    engine.core.clock = WallClock()
    engine.submit(reqs)
    engine.core.run()
    engine.core.finished.clear()
    engine.backend._sync()


def run_window(engine, scorer, requests, window_s: float, *, drain: bool,
               trace: bool, slice_at: float, slice_s: float,
               trace_path: Optional[str] = None) -> Window:
    """Serve ``requests`` from a clock origin at the window's start.

    Without ``drain`` serving stops at the window's end; with it serving
    goes on until every request has finished, for at most another
    ``window_s``. In a traced run ``torch.profiler`` covers ``slice_s``
    seconds of serving from the first step that ends after ``slice_at``."""
    from repro_torch.serving.core import WallClock

    core, backend, sched = engine.core, engine.backend, engine.scheduler
    w = Window(window_s=window_s, requests=list(requests))
    state = {"tokens": 0, "prof": None, "t_prof": 0.0, "done": False,
             "rows": 0, "span": False, "start": 0.0, "until": 0.0}
    scorer.seconds, scorer.scored = 0.0, 0
    p0, inst0 = backend.prefill_seconds, backend.prefix_installs

    def span(name):
        return (torch.profiler.record_function(name) if state["span"]
                else nullcontext())

    orig_schedule = sched.schedule
    orig_prefill = backend.prefill
    orig_decode = backend.decode

    def schedule(now):
        state["start"] = now
        t0 = time.perf_counter()
        with span("core.schedule"):
            admitted = orig_schedule(now)
        host.phase["schedule"] += time.perf_counter() - t0
        if admitted:
            w.admissions.append(([r.req_id for r in admitted
                                  if not r.boosted],
                                 [r.req_id for r in sched.waiting
                                  if not r.boosted]))
        return admitted

    def prefill(chunks, now):
        w.prefill_calls.append([(r.req_id, s, e) for r, s, e in chunks])
        done = 0
        for r, s, e in chunks:
            n = len(backend._prompt_ids(r))
            done += e >= backend.prefill_total(r)
            w.prefill_tokens.append((now, min(s, n), min(e, n)))
        t0 = time.perf_counter()
        with span("engine.prefill"):
            out = orig_prefill(chunks, now)
        host.phase["prefill"] += time.perf_counter() - t0
        state["tokens"] += done
        return out

    def decode(now):
        ready = core.decode_ready
        active = [r for r in backend.slot_req if r is not None and ready(r)]
        state["rows"] = len(active)
        w.decode_calls.append((now, [backend._pos[r.req_id] for r in active],
                               state["prof"] is not None))
        t0 = time.perf_counter()
        with span("engine.decode"):
            out = orig_decode(now)
        host.phase["decode"] += time.perf_counter() - t0
        state["tokens"] += len(active)
        return out

    def on_step(_core, now):
        w.steps.append((state["start"], now, state["rows"]))
        state["rows"] = 0
        host.tick()
        if now <= window_s:
            w.tokens_at.append((now, state["tokens"]))
        if trace:
            _slice(now)

    def _slice(now):
        if state["prof"] is None and not state["done"] and now >= slice_at:
            p = profiler()
            p.start()
            state["prof"], state["span"] = p, True
            scorer.span = True
            state["t_prof"] = time.perf_counter()
            # the slice runs from when the profiler is up
            up = core.clock.now()
            w.paused.append((now, up))
            state["until"] = up + slice_s
        elif state["prof"] is not None and now >= state["until"]:
            backend._sync()
            wall = time.perf_counter() - state["t_prof"]
            p = state["prof"]
            p.stop()
            w.paused.append((now, core.clock.now()))
            state["prof"], state["span"], state["done"] = None, False, True
            scorer.span = False
            state["stopped"] = (p, wall)    # read once serving has ended

    sched.schedule, backend.prefill, backend.decode = \
        schedule, prefill, decode
    host = w.host = HostMeter()
    try:
        core.clock = WallClock()
        core.submit(requests)
        limit = 2 * window_s if drain else window_s
        host.start()
        while True:
            now = core.clock.now()
            if now >= limit:
                break
            if core.tick(on_step=on_step) is None:
                break
        w.serve_s = core.clock.now()
        backend._sync()
        host.stop()
        if "stopped" in state:
            p, wall = state["stopped"]
            w.slice = prof_mod.read(p, wall)
            if trace_path:
                w.trace_file = _export(p, trace_path)
    finally:
        sched.schedule, backend.prefill, backend.decode = \
            orig_schedule, orig_prefill, orig_decode
        if state["prof"] is not None:
            state["prof"].stop()
    w.prefill_s = backend.prefill_seconds - p0
    w.prefix_installs = backend.prefix_installs - inst0
    w.scorer_s, w.scored = scorer.seconds, scorer.scored
    w.backlog = sum(1 for r in requests if r.finish_time is None)
    for r in requests:
        if r.finish_time is not None:
            t = w.drained_by.get(r.arrival_time, 0.0)
            w.drained_by[r.arrival_time] = max(t, r.finish_time)
    return w


def profiler():
    """The traced run's profiler: host operators and device activity."""
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def warm_profiler(engine) -> float:
    """Start, stop and read the profiler once over a small product on the
    device in set-up, so that the window's start and stop pay no
    first-use cost (CUPTI's own start-up takes seconds); returns the
    seconds it took."""
    t0 = time.perf_counter()
    p = profiler()
    p.start()
    x = torch.ones(256, 256, device=engine.backend.device)
    (x @ x).sum().item()
    p.stop()
    prof_mod.read(p, time.perf_counter() - t0)
    return time.perf_counter() - t0


def _export(prof, path: str) -> str:
    """The slice's Chrome trace, gzip-compressed beside ``path``."""
    import gzip
    import os
    import shutil
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    return path + ".gz"


def free(engine) -> None:
    """Drop the engine's caches (the engine and its core refer to each
    other, so the cycle collector has to run)."""
    import gc
    engine.backend.k_pool = engine.backend.v_pool = None
    engine.backend.lanes = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


