"""One run of a benchmark cell with the program's own tracer on, read over
the whole window: where a served step's host time goes.

    python3 bench/trace_window.py --workload <cell> --seed <n> \\
        [--seconds 51] [--tracer 0|1] [--trace 0|1]

From the root of a checkout, on a machine with the cell's card. The run is
``bench/run.py``'s (``bench/harness/cell.py::run``, its check included);
with ``--tracer 1`` the program's tracer (``repro_torch.trace``) records
from before set-up, with ``--tracer 0`` the same run is served with it off
(the tracer's cost is the difference), and ``--trace 1`` also profiles the
benchmark's slice. Besides the run's lines and metrics it prints:

- ``counters:`` the window's deltas of the program's counters
  (``RealBackend.decode_steps``, ``decode_seconds``, ``prefill_seconds``,
  ``dropped_slots``; ``RankingPredictor.scored``, ``score_seconds``);
- with the tracer on, ``program:`` the count, total and self seconds of
  each span name over the window, the window's ``on_step`` calls and the
  harness's decode seconds beside them, and the set-up split (``setup.*``
  spans around the harness's set-up calls; ``kernels.build`` runs inside
  ``setup.warm_up``);
- ``spans:`` :func:`readings` over the window's spans that no profiler
  start or stop held up;
- with ``--trace 1`` as well, ``slice:`` the share of the slice's
  device-idle time under a recorded run-loop span, and how far each
  recorded ``core.step`` starts from the profiler's event of the same
  range.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from contextlib import ExitStack  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(rec, lo: int, hi: int, paused=()) -> dict:
    """Four readings of the spans ``rec`` (a whole ``trace.records()``
    list) that lie in ``[lo, hi]`` and overlap no ``paused`` interval (ns
    on the profiler's clock), each left out where it has no span:

    - ``ranking_ms_per_request``: ``predictor.score`` ms per prompt scored;
    - ``core_self_ms``: mean self time of ``core.step`` (its own
      scheduling, admission, chunk planning, KV accounting and retirement;
      in a benchmark run also the harness's bookkeeping around
      ``schedule``, ``prefill`` and ``decode``), its children being
      ``backend.prefill``, ``backend.decode`` and ``predictor.score``;
    - ``decode_host_ms``: mean ``backend.decode`` less its
      ``backend.sync``, over the calls that decoded (the host's time to
      prepare and enqueue a step);
    - ``decode_sync_ms``: the mean of that ``backend.sync`` (the wait for
      the device after the enqueue)."""
    from repro_torch import trace

    def kept(s):
        return (s.end and lo <= s.start and s.end <= hi
                and not any(s.start < b and a < s.end for a, b in paused))
    own = trace.self_ns(rec)
    out = {}
    scores = [s for s in rec if s.name == "predictor.score" and kept(s)]
    prompts = sum(s.n for s in scores)
    if prompts:
        out["ranking_ms_per_request"] = (
            sum(s.end - s.start for s in scores) / prompts / 1e6)
    steps = [own[i] for i, s in enumerate(rec)
             if s.name == "core.step" and kept(s)]
    if steps:
        out["core_self_ms"] = statistics.fmean(steps) / 1e6
    sync = {s.parent: s.end - s.start for s in rec
            if s.name == "backend.sync" and s.parent >= 0
            and rec[s.parent].name == "backend.decode"}
    decodes = [(rec[i].end - rec[i].start, ns) for i, ns in sync.items()
               if kept(rec[i])]
    if decodes:
        out["decode_host_ms"] = statistics.fmean(
            whole - ns for whole, ns in decodes) / 1e6
        out["decode_sync_ms"] = statistics.fmean(
            ns for _whole, ns in decodes) / 1e6
    return out


def _counters(engine, scorer) -> tuple:
    b, p = engine.backend, scorer.predictor
    return (b.decode_steps, b.decode_seconds, b.prefill_seconds,
            b.dropped_slots, p.scored, p.score_seconds)


COUNTERS = ("decode_steps", "decode_seconds", "prefill_seconds",
            "dropped_slots", "scored", "score_seconds")


def _covered(gaps, spans) -> int:
    """ns of the intervals ``gaps`` that lie under ``spans`` (sorted, none
    overlapping another)."""
    starts = [a for a, _b in spans]
    total = 0
    for ga, gb in gaps:
        i = max(bisect.bisect_right(starts, ga) - 1, 0)
        while i < len(spans) and spans[i][0] < gb:
            a, b = spans[i]
            total += max(0, min(b, gb) - max(a, ga))
            i += 1
    return total


def _slice(sl, rec) -> dict:
    """The idle share of the profiled slice ``sl`` under a recorded root
    span (the run loop's ``core.tick``), and the recorded ``core.step``
    starts less the profiler's events of that range (ns)."""
    gaps, end = [], None
    for a, b, _ in sorted(sl.device):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    idle = sum(b - a for a, b in gaps)
    roots = sorted((s.start, s.end) for s in rec if s.parent == -1 and s.end)
    ours = sorted(s.start for s in rec if s.name == "core.step")
    offsets = []
    for a, _b, name, user in sl.host:
        if user and name == "core.step" and ours:
            i = bisect.bisect_left(ours, a)
            near = [ours[j] for j in (i - 1, i) if 0 <= j < len(ours)]
            offsets.append(min(near, key=lambda t: abs(t - a)) - a)
    return {"idle_s": idle / 1e9, "slice_s": sl.window_s,
            "idle_under_spans": _covered(gaps, roots) / idle if idle else None,
            "core_step_offset_ns": ({"median": statistics.median(offsets),
                                     "min": min(offsets),
                                     "max": max(offsets),
                                     "n": len(offsets)} if offsets else None)}


def measure(cell, seed: int, seconds: float, tracer: bool, traced: bool,
            device, log=print, t_start: float = T_START) -> dict:
    """One run of ``cell`` (``cell.run``) with the program's tracer on from
    set-up (``tracer``) or off; returns the run's output (``out``), the
    window's counter deltas, and with the tracer the span table, the set-up
    split, :func:`readings` and, ``traced``, the slice's figures."""
    from bench.harness import cell as cell_mod, serve, weights
    from repro_torch import trace

    box = {}

    def window(engine, scorer, *a, **k):
        c0 = _counters(engine, scorer)
        box["t0"] = trace.to_ns(time.perf_counter())
        w = run_window(engine, scorer, *a, **k)
        box["t1"] = trace.to_ns(time.perf_counter())
        origin = time.perf_counter() - engine.core.clock.now()
        box["paused"] = [(trace.to_ns(origin + a), trace.to_ns(origin + b))
                         for a, b in w.paused]
        box["counters"] = {n: after - before for n, before, after in
                           zip(COUNTERS, c0, _counters(engine, scorer))}
        return w

    run_window = serve.run_window
    setup = ((weights, "make_params", "setup.weights"),
             (cell_mod, "predictor_for", "setup.predictor"),
             (serve, "build", "setup.engine"),
             (serve, "warm_up", "setup.warm_up"),
             (serve, "warm_profiler", "setup.profiler"))
    trace.reset()
    if tracer:
        trace.enable()
    try:
        with ExitStack() as stack:
            for mod, name, span in setup:
                stack.enter_context(mock.patch.object(
                    mod, name, trace.traced(span)(getattr(mod, name))))
            stack.enter_context(mock.patch.object(serve, "run_window",
                                                  window))
            out = cell_mod.run(cell, seed, seconds, traced, device, t_start,
                               log=log)
        trace.disable()
        res = {"out": out, "counters": box["counters"]}
        rec = trace.records()
        if not rec:
            return res
        lo, hi = box["t0"], box["t1"]
        res["program"] = {k: [n, t, o] for k, (n, t, o) in sorted(
            trace.summary(rec, lo, hi).items(), key=lambda kv: -kv[1][1])}
        res["setup"] = {k: t for k, (_n, t, _o) in trace.summary(
            rec, 0, lo).items() if k.startswith("setup.")
            or k == "kernels.build"}
        res["spans"] = readings(rec, lo, hi, box["paused"])
        res["skipped"] = trace.skipped()
        if traced and out["window"].slice is not None:
            res["slice"] = _slice(out["window"].slice, rec)
        return res
    finally:
        trace.disable()
        trace.reset()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import run as run_mod
    run_mod._caches()
    import torch

    from bench.harness import spec

    cell = spec.find(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; tracer {args.tracer}, trace {args.trace}",
          flush=True)
    res = measure(cell, args.seed, args.seconds, bool(args.tracer),
                  bool(args.trace), dev, log=lambda s: print(s, flush=True))
    out = res["out"]
    for line in out["info"]:
        print(line)
    result = out["result"]
    print("metrics: " + json.dumps({k: v["value"] for k, v in
                                    result["metrics"].items()}))
    if "breakdown" in result:
        print("idle_gaps: " + json.dumps(result["breakdown"]["idle_gaps"]))
    print(f"correct {result['correct']}, failed {result['failed']} of "
          f"{result['attempted']}; memory peak {out['memory_peak_bytes']}")
    print("counters: " + json.dumps(res["counters"]))
    if "program" in res:
        w = out["window"]
        print("program: " + json.dumps({
            "spans": res["program"], "on_step_calls": len(w.steps),
            "harness_decode_s": w.host.phase["decode"],
            "setup": res["setup"], "skipped": res["skipped"]}))
        print("spans: " + json.dumps(res["spans"]))
    if "slice" in res:
        print("slice: " + json.dumps(res["slice"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
