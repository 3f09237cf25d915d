"""``bench/trace_window.py``: the readings of the program's recorded spans
over a window (hand-worked records, silence without the spans, the
profiler's pauses left out), and a tiny run on the CPU with the tracer on
from set-up, beside one with it off."""
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bench_tiny as tiny  # noqa: E402

from bench import trace_window as tw  # noqa: E402
from bench.harness import cell as cell_mod  # noqa: E402
from bench.harness.profile import Slice  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.trace import Span  # noqa: E402

SPAN_METRICS = ("ranking_ms_per_request", "core_self_ms", "decode_host_ms",
                "decode_sync_ms")
MS = 1_000_000


def _records(rows):
    """Spans from ``(name, start ms, end ms, parent, n)`` rows."""
    return [Span(name, a * MS, b * MS, parent, None, n)
            for name, a, b, parent, n in rows]


# a tick scoring two arrivals, then a step that prefills; a second tick
# whose step re-ranks three and decodes; a third whose decode call finds
# no row ready (no sync)
ROWS = [("core.tick", 0, 20, -1, -1),
        ("predictor.score", 1, 3, 0, 2),
        ("core.step", 4, 19, 0, -1),
        ("backend.prefill", 6, 16, 2, -1),
        ("backend.sync", 14, 16, 3, -1),
        ("core.tick", 30, 60, -1, -1),
        ("core.step", 31, 59, 5, -1),
        ("predictor.score", 32, 38, 6, 3),
        ("backend.decode", 40, 58, 6, -1),
        ("backend.tables", 41, 44, 8, -1),
        ("backend.sync", 52, 56, 8, -1),
        ("core.tick", 70, 80, -1, -1),
        ("core.step", 71, 79, 11, -1),
        ("backend.decode", 72, 73, 12, -1)]


@pytest.mark.parametrize("metric,want", [
    # 8 ms of scoring over 5 prompts
    ("ranking_ms_per_request", 8.0 / 5),
    ("core_self_ms", ((15 - 10) + (28 - 6 - 18) + (8 - 1)) / 3),
    ("decode_host_ms", 18.0 - 4.0), ("decode_sync_ms", 4.0)])
def test_readings_on_hand_worked_records(metric, want):
    got = tw.readings(_records(ROWS), 0, 100 * MS)
    assert got[metric] == pytest.approx(want)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readings_are_silent_without_their_spans(metric):
    """Records of only the run loop, and records outside the window."""
    loop = [r for r in ROWS if r[0] == "core.tick"]
    assert metric not in tw.readings(_records(loop), 0, 100 * MS)
    assert metric not in tw.readings(_records(ROWS), 200 * MS, 300 * MS)


def test_readings_leave_out_what_a_pause_held_up():
    """Pauses over the second tick's scoring and decode leave the first
    tick's scoring and step, and the empty third step."""
    got = tw.readings(_records(ROWS), 0, 100 * MS,
                      paused=[(35 * MS, 36 * MS), (50 * MS, 51 * MS)])
    assert got["ranking_ms_per_request"] == pytest.approx(1.0)
    assert got["core_self_ms"] == pytest.approx((5 + 7) / 2)
    assert "decode_host_ms" not in got and "decode_sync_ms" not in got


@pytest.mark.parametrize("tracer", [True, False])
def test_tiny_run_with_the_tracer(tracer, monkeypatch):
    """A traced tiny run whose slice starts at the first step. With the
    tracer on: the four readings, a ``core.step`` span per ``on_step``
    call, ``backend.decode`` seconds within 2% of the harness's decode
    seconds, the set-up split, and the recorded steps within 200 us of the
    profiler's events of the same range. Off: counters only. Either way the tracer
    is off and empty afterwards."""
    monkeypatch.setattr(cell_mod, "SLICE_LEAD_S", 10.0)
    monkeypatch.setattr(cell_mod, "SLICE_S", 2.0)
    c = tiny.cell("moe", "burst")
    res = tw.measure(c, 2**33 + 7, 4.5, tracer, True, torch.device("cpu"),
                     log=lambda s: None, t_start=time.perf_counter())
    w = res["out"]["window"]
    assert res["counters"]["decode_steps"] > 0
    assert res["counters"]["scored"] == w.scored > 0
    assert not trace.enabled() and trace.records() == []
    if not tracer:
        assert "program" not in res and "spans" not in res
        return
    assert set(res["spans"]) == set(SPAN_METRICS)
    assert all(v > 0 for v in res["spans"].values())
    prog = res["program"]
    assert prog["core.step"][0] == len(w.steps)
    assert prog["backend.decode"][1] == pytest.approx(
        w.host.phase["decode"], rel=0.02)
    assert {"setup.weights", "setup.predictor", "setup.engine",
            "setup.warm_up", "setup.profiler"} <= set(res["setup"])
    assert res["skipped"] == 0
    # the CPU has no device trace: the steps' clock alone
    offsets = res["slice"]["core_step_offset_ns"]
    assert offsets["n"] > 0 and abs(offsets["median"]) < 200_000


def test_slice_idle_under_the_run_loop_and_step_offsets():
    """Device busy 0-10, 20-30 and 50-60 ms: 30 ms idle, 25 of them under
    the two ticks; each recorded step starts 2 us after its event."""
    sl = Slice(window_s=0.06)
    sl.device = [(a * MS, b * MS, "k") for a, b in
                 ((0, 10), (20, 30), (50, 60))]
    sl.host = [(a * MS - 2000, b * MS, "core.step", True)
               for a, b in ((6, 24), (29, 44))] + [
        (0, 60 * MS, "aten::mm", False)]
    rec = _records([("core.tick", 5, 25, -1, -1),
                    ("core.step", 6, 24, 0, -1),
                    ("core.tick", 28, 45, -1, -1),
                    ("core.step", 29, 44, 2, -1)])
    got = tw._slice(sl, rec)
    assert got["idle_s"] == pytest.approx(0.030)
    assert got["idle_under_spans"] == pytest.approx(25 / 30)
    assert got["core_step_offset_ns"] == {"median": 2000, "min": 2000,
                                          "max": 2000, "n": 2}
