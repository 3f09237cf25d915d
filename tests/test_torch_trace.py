"""The port's tracer (``repro_torch.trace``) and the serving path's
counters, on the CPU at smoke widths: off, it records nothing and opens no
range outside a profiler; on, the spans of a served burst form a tree on
the profiler's clock with each request's id on its prefill and decode
spans; the engine's decode and MoE drop counters, its first-chunk
replays' span and counter, and the predictor's scoring counters."""
import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.core.predictor.backbones import PredictorConfig
from repro_torch.core.predictor.train import RankingPredictor
from repro_torch.core.scheduler.policies import fcfs, make_policy
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.models import transformer as tfm
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import BlockAllocator


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _cfg(capacity_factor=1.25):
    cfg = get_smoke_config("olmoe_1b_7b").replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


@pytest.fixture(scope="module")
def params():
    return tfm.init_params(_cfg(), 0, device="cpu")


def _requests(n=6):
    return [Request(req_id=i, prompt=" ".join(f"w{i}x{j}"
                                              for j in range(5 + 3 * i)),
                    arrival_time=0.0, prompt_len=5 + 3 * i,
                    true_length=3 + i) for i in range(n)]


def _serve(params, cfg=None, policy=None, chunk=None, n=6):
    eng = Engine(cfg or _cfg(), params,
                 Scheduler(policy=policy or fcfs(), max_batch=4),
                 cache_len=64, prompt_len=32,
                 allocator=BlockAllocator(64, 16), record_tokens=True,
                 config=ServingConfig(prefill_chunk_tokens=chunk),
                 device="cpu")
    eng.submit(_requests(n))
    fin = eng.run()
    return {r.req_id: list(r.generated_tokens) for r in fin}, eng


def test_off_records_nothing_and_opens_no_range(params, monkeypatch):
    """Off and without a profiler, a span is the shared null context: no
    record, no ``record_function``; the greedy tokens equal a run without
    the tracer's spans and a run with the tracer on."""
    built = []
    monkeypatch.setattr(trace, "record_function",
                        lambda name: built.append(name))
    assert trace.span("x") is trace.span("y")
    with trace.span("x") as s:
        trace.ids(_requests(1))
        assert s is None
    off, _ = _serve(params)
    assert trace.records() == [] and built == []

    with monkeypatch.context() as m:
        m.setattr(trace, "span", lambda *a, **k: contextlib.nullcontext())
        bare, _ = _serve(params)
    trace.enable()
    on, _ = _serve(params)
    trace.disable()
    assert built == []
    assert off == bare == on and len(off) == 6
    assert trace.records()


def test_off_under_a_profiler_opens_ranges_and_records_nothing(params):
    """Off, under a running profiler each span is a range of its name
    (what names a profile's idle gaps); nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(params, n=2)
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert {"core.tick", "core.step", "backend.prefill", "backend.decode",
            "backend.tables", "backend.sync", "model.decode_step",
            "model.layer", "model.attn", "model.ffn",
            "moe.experts"} <= names
    assert trace.records() == []


def test_span_tree_of_a_served_burst(params):
    """Every span closes inside its parent; each decode and prefill span
    sits in a ``core.step``, each step in a ``core.tick``; every request's
    id is on its prefill span and on each of its decode spans; the
    admitted ids ride on ``core.step``; self time is the span less its
    children."""
    trace.enable()
    fin, eng = _serve(params, chunk=16)
    trace.disable()
    rec = trace.records()
    by_name = {}
    for s in rec:
        by_name.setdefault(s.name, []).append(s)
    for s in rec:
        assert s.end >= s.start > 0
        if s.parent >= 0:
            p = rec[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
    parent = {"backend.decode": "core.step", "backend.prefill": "core.step",
              "core.step": "core.tick", "model.decode_step": "backend.decode",
              "model.forward_chunk": "backend.prefill",
              "model.forward_seq": "backend.prefill",
              "model.attn": "model.layer", "model.ffn": "model.layer",
              "moe.router": "model.ffn", "backend.sync": None}
    for name, want in parent.items():
        assert by_name[name], name
        for s in by_name[name]:
            if want is not None:
                assert rec[s.parent].name == want, (name, rec[s.parent].name)
    for s in by_name["backend.sync"]:
        assert rec[s.parent].name in ("backend.decode", "backend.prefill")
    assert {s.n for s in by_name["model.layer"]} == set(
        range(_cfg().num_layers))
    assert all(rec[s.parent].parent == -1 for s in by_name["core.step"])
    decodes = by_name["backend.decode"]
    for rid, tokens in fin.items():
        assert any(rid in (s.ids or ()) for s in by_name["backend.prefill"])
        # the prefill emits the first token, each decode step one more
        assert sum(rid in (s.ids or ()) for s in decodes) == len(tokens) - 1
        assert sum(rid in (s.ids or ()) for s in by_name["core.step"]) == 1
    # a step whose running requests are all mid-prompt decodes no row
    assert sum(bool(s.ids) for s in decodes) == eng.backend.decode_steps
    own = trace.self_ns(rec)
    for i, s in enumerate(rec):
        kids = sum(c.end - c.start for c in rec if c.parent == i)
        assert own[i] == (s.end - s.start) - kids
    table = trace.summary(rec)
    n, total, self_s = table["backend.decode"]
    assert n == len(decodes)
    assert total == pytest.approx(sum(s.seconds for s in decodes))
    assert self_s == pytest.approx(sum(own[i] for i, s in enumerate(rec)
                                       if s.name == "backend.decode") / 1e9)
    cut = decodes[len(decodes) // 2].start
    assert trace.summary(rec, start=cut)["backend.decode"][0] == \
        len(decodes) - len(decodes) // 2


def test_spans_lie_on_the_profilers_clock():
    """Recorded spans under a CPU profiler lie within 200 us of the
    profiler's events of the same ranges (the median of five; the session's
    first range, which pays the profiler's first-use cost, is left out)."""
    from torch.profiler import ProfilerActivity, profile
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ["clock.first"] + ["clock.probe"] * 5:
            with trace.span(name):
                torch.ones(64, 64).sum()
    trace.disable()
    events = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "clock.probe")
    spans = [(s.start, s.end) for s in trace.records()
             if s.name == "clock.probe"]
    assert len(events) == len(spans) == 5
    for edge in (0, 1):
        gaps = sorted(abs(e[edge] - s[edge]) for e, s in zip(events, spans))
        assert gaps[2] < 200_000, gaps


def test_engine_counts_moe_drops_and_decode_steps(params, monkeypatch):
    """At capacity factor 0.5 the dispatches drop slots: the engine's
    ``dropped_slots`` is the sum, over every forward (first chunks,
    continuation chunks and decode steps), of the drops at real positions:
    the rows on a real table (not a decode step's padding rows, nor an MoE
    first chunk's replayed lanes) and the non-pad tokens; pad positions
    drop slots too, and are left out. ``decode_steps`` and
    ``decode_seconds`` advance once per decode dispatch."""
    cfg = _cfg(capacity_factor=0.5)
    seen = {"drops": 0, "all": 0, "calls": 0}

    def counting(fn):
        def wrapped(params, cfg, x, y=None, **k):
            out = fn(params, cfg, x, **k) if y is None else \
                fn(params, cfg, x, y, **k)
            # (tokens, cache) but decode_step's (cache, token)
            tokens, cache = ((y, x) if fn is decode_step
                             else (x, k.get("cache", y)))
            # the rows on a real table: no padding row, no replayed lane
            rows = int((cache["tables"][:, 0] != b._null_block).sum())
            drops = out[-1]["token_drops"]
            assert int(drops.sum()) == int(out[-1]["dropped_slots"])
            seen["all"] += int(drops.sum())
            seen["drops"] += int((drops[:rows] * (tokens[:rows] != 0)).sum())
            return out
        return wrapped
    decode_step = tfm.decode_step
    for name in ("forward_seq", "forward_chunk", "decode_step"):
        monkeypatch.setattr(tfm, name, counting(getattr(tfm, name)))
    eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=4),
                 cache_len=64, prompt_len=32,
                 allocator=BlockAllocator(64, 16),
                 config=ServingConfig(prefill_chunk_tokens=16), device="cpu")
    b = eng.backend
    real = b.decode

    def decode(now):
        steps, seconds = b.decode_steps, b.decode_seconds
        out = real(now)
        stepped = b.decode_steps - steps
        assert stepped in (0, 1)
        assert (b.decode_seconds > seconds) == bool(stepped)
        seen["calls"] += stepped
        return out
    b.decode = decode
    eng.submit(_requests())
    eng.run()
    assert b.extend_dispatches > 0 and seen["calls"] == b.decode_steps > 0
    assert b.dropped_slots == seen["drops"] > 0
    assert seen["all"] > seen["drops"]
    assert isinstance(b.dropped_slots, int)
    # the pad token 0 is no prompt token
    assert all(0 not in b.tok.encode(r.prompt) for r in _requests())


def test_first_chunk_replays_are_spans_and_counted(params):
    """First chunks on the grid stage into their captured steps inside
    ``backend.tables`` in ``backend.prefill``, every first chunk here, and
    run the steps, which the CPU cannot replay: no ``backend.replay`` span
    and no ``prefill_graph_dispatches`` (a replay is one of each). The
    staged engine's tokens and MoE drops are those of the eager first
    chunks, which stage nothing."""
    runs = {}
    for staged in (False, True):
        eng = Engine(_cfg(capacity_factor=0.5), params,
                     Scheduler(policy=fcfs(), max_batch=4), cache_len=64,
                     prompt_len=32, allocator=BlockAllocator(64, 16),
                     record_tokens=True,
                     config=ServingConfig(prefill_chunk_tokens=16),
                     device="cpu")
        b = eng.backend
        if not staged:             # every first chunk as off the grid
            b._first_shapes.clear()
        for step in b._first_shapes.values():
            def stage(*args, inner=step.stage):
                with trace.span("test.stage"):
                    inner(*args)
            step.stage = stage
        trace.enable()
        eng.submit(_requests())
        fin = eng.run()
        trace.disable()
        rec = trace.records()
        trace.reset()
        replays = [s for s in rec if s.name == "backend.replay"
                   and rec[s.parent].name == "backend.prefill"]
        stagings = [s for s in rec if s.name == "test.stage"]
        assert all(rec[s.parent].name == "backend.tables"
                   and rec[rec[s.parent].parent].name == "backend.prefill"
                   for s in stagings)
        assert len(stagings) == (b.prefill_dispatches if staged else 0)
        assert len(replays) == b.prefill_graph_dispatches == 0
        runs[staged] = ({r.req_id: r.generated_tokens for r in fin},
                        b.dropped_slots)
    assert runs[True] == runs[False] and runs[True][1] > 0


def test_predictor_counts_prompts_and_seconds():
    """``score`` counts its prompts and wall seconds, and runs in
    ``predictor.score`` with its three stages."""
    pred = RankingPredictor.init(PredictorConfig(), 0, device="cpu")
    prompts = ["a short one", "a longer prompt with more words in it", "x"]
    trace.enable()
    first = pred.score(prompts)
    trace.disable()
    pred.score(prompts[:1])
    assert pred.scored == 4 and pred.score_seconds > 0
    np.testing.assert_array_equal(
        first, pred.score_tokens(pred.tokenizer.encode_batch(prompts)))
    rec = trace.records()
    assert [s.name for s in rec] == ["predictor.score", "predictor.tokenize",
                                     "predictor.forward",
                                     "predictor.readback"]
    assert [s.parent for s in rec] == [-1, 0, 0, 0]


def test_arrivals_are_scored_inside_the_tick(params):
    """PARS scores arrivals in ``core.tick`` before its ``core.step``."""
    pred = RankingPredictor.init(PredictorConfig(), 0, device="cpu")
    trace.enable()
    _serve(params, policy=make_policy("pars", pred), n=3)
    trace.disable()
    rec = trace.records()
    scores = [s for s in rec if s.name == "predictor.score"]
    assert scores and all(rec[s.parent].name == "core.tick"
                          for s in scores)
    assert pred.scored == 3


def test_records_are_bounded_and_feed_no_collector(monkeypatch):
    """Past ``LIMIT`` rows spans are counted, not kept; recording makes no
    object the garbage collector tracks; ``reset`` forgets both."""
    monkeypatch.setattr(trace, "LIMIT", 100)
    trace.enable()
    gc.collect()
    before = gc.get_count()[0]
    for i in range(1000):
        with trace.span("x", i):
            with trace.span("y"):
                pass
    grown = gc.get_count()[0] - before
    trace.disable()
    rec = trace.records()
    assert len(rec) == 100 and trace.skipped() == 1900
    assert [(s.name, s.parent, s.n) for s in rec[:4]] == [
        ("x", -1, 0), ("y", 0, -1), ("x", -1, 1), ("y", 2, -1)]
    assert grown < 50, grown
    trace.reset()
    assert trace.records() == [] and trace.skipped() == 0


def test_kernel_build_is_a_root_span():
    from repro_torch.kernels import build
    trace.enable()
    assert build.build_all(()) == {}
    trace.disable()
    assert [(s.name, s.parent) for s in trace.records()] == [
        ("kernels.build", -1)]


def test_latent_spans_and_expanded_rows(monkeypatch):
    """Moonlight's smoke model served with chunked prefill: decode opens
    ``mla.absorb``, ``mla.latent`` and ``mla.unabsorb`` in each layer's
    ``model.attn``, continuation chunks ``mla.latent`` and ``mla.expand``,
    each MoE layer's ``model.ffn`` a ``moe.shared`` (the dense layer 0
    none); ``latent_rows_expanded`` counts each continuation dispatch's
    gathered latent rows once a layer."""
    cfg = get_smoke_config("moonlight_16b_a3b").replace(dtype="float32")
    params = tfm.init_params(cfg, 0, device="cpu")
    gathered = []
    chunk = tfm.forward_chunk

    def watched(p, c, tokens, cache):
        gathered.append(cache["tables"].numel() * cache["latent"].shape[2])
        return chunk(p, c, tokens, cache)
    monkeypatch.setattr(tfm, "forward_chunk", watched)
    trace.enable()
    fin, eng = _serve(params, cfg=cfg, chunk=16)
    trace.disable()
    assert len(fin) == 6
    rec = trace.records()
    by_name = {}
    for s in rec:
        by_name.setdefault(s.name, []).append(s)
    parent = {"mla.absorb": "model.attn", "mla.unabsorb": "model.attn",
              "mla.latent": "model.attn", "mla.expand": "model.attn",
              "moe.shared": "model.ffn"}
    for name, want in parent.items():
        assert by_name[name], name
        assert all(rec[s.parent].name == want for s in by_name[name]), name
    layer_of = {s.parent: rec[rec[s.parent].parent].n
                for s in by_name["moe.shared"]}
    assert set(layer_of.values()) == set(range(1, cfg.num_layers))
    steps = len(by_name["model.decode_step"])
    assert len(by_name["mla.absorb"]) == steps * cfg.num_layers
    assert len(by_name["mla.expand"]) == len(gathered) * cfg.num_layers
    assert gathered and eng.backend.latent_rows_expanded == \
        sum(gathered) * cfg.num_layers
    # a chunk gathers only the entries its keys reach, not whole lanes
    assert max(gathered) < 4 * 64
