"""The port's tracer: named spans where the serving path does its work.

``with span("backend.decode"):`` marks one piece of work. The tracer is
off by default, and then a span costs one flag test and one test of
whether a ``torch.profiler`` session runs: without one it is a shared
null context and builds nothing; under one it is a ``record_function``
range of the same name, so a profile's host events name the program's
work (this is the one place the port opens such ranges).

:func:`enable` turns recording on. Each span is then kept as one row of
a few columns (no object per span: a served window holds hundreds of
thousands, and objects would feed the garbage collector), at most
``LIMIT`` rows until :func:`reset`; past it spans are counted
(:func:`skipped`) and not kept. :func:`records` gives the rows as
:class:`Span` tuples: the name, start and end in ns on the profiler's
clock (Unix time, as ``torch.profiler``'s events give it: spans recorded
on ``time.perf_counter_ns`` shifted by an offset taken at :func:`enable`;
:func:`to_ns` converts a ``perf_counter`` reading), the index of the
parent span in :func:`records`, the ids of the requests the span serves
(:func:`ids`) and an integer it carries (``n``: a layer's index, the
prompts a score took). Under a profiler a recorded span opens its
``record_function`` range too. :func:`summary` gives the count, total
and self seconds of each name.

Spans of the serving path (parent in brackets): ``core.tick`` (root);
``predictor.score`` (``core.tick`` at arrivals, ``core.step`` at a
re-rank) with ``predictor.tokenize``, ``predictor.forward`` and
``predictor.readback``; ``core.step`` (``core.tick``); ``backend.prefill``
and ``backend.decode`` (``core.step``) with ``backend.tables``,
``model.forward_seq``, ``model.forward_chunk`` or ``model.decode_step``
(or ``backend.replay``, the replay of a decode step's graph or of an MoE
first chunk's, which fires no ``model.*`` span: the backend's
``decode_graph_steps`` and ``prefill_graph_dispatches`` count them),
``backend.sample``, ``backend.sync`` and ``backend.record``;
``model.layer`` (``model.*``) with ``model.attn`` and ``model.ffn``, an
MoE layer's ``moe.router``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` inside ``model.ffn``, and its shared experts'
``moe.shared``; latent attention's (MLA's) ``mla.latent`` (the latent rows'
write, and in decode the latent kernel), ``mla.expand`` (a continuation
chunk's gathered lane through ``wkv_b``), ``mla.absorb`` and
``mla.unabsorb`` (decode's query and output folds) and ``mla.q_lora`` (the
query low-rank path, where the config has one) inside ``model.attn``;
``kernels.build`` (root).
"""
from __future__ import annotations

import contextlib
import functools
import time
from array import array
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
from torch.profiler import record_function

_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One recorded span; ``end`` is 0 while it is open."""
    name: str
    start: int                      # ns, profiler clock
    end: int
    parent: int                     # index in records(); -1 for a root
    ids: Optional[Tuple[int, ...]]
    n: int                          # -1 where the span carries none

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


LIMIT = 2_000_000               # rows kept, some 40 bytes each
_NULL = contextlib.nullcontext()
_clock = time.perf_counter_ns
_on = False
_skipped = 0
_offset = 0                     # profiler clock - perf_counter, in ns
_name, _n = "", -1              # the span that enters next
# the records, one column each
_names: List[str] = []
_starts = array("q")
_ends = array("q")
_parents = array("q")
_ns = array("q")
_ids: Dict[int, Tuple[int, ...]] = {}
_open: List[int] = []           # rows of the open spans, innermost last
_ranges: list = []              # each open span's profiler range, or None


class _Recorder:
    """The context of every recorded span (one shared object: spans nest,
    so the open ones are a stack)."""

    def __enter__(self) -> None:
        name = _name
        rf = record_function(name) if _profiling() else None
        if rf is not None:
            rf.__enter__()
        _open.append(len(_names))
        _ranges.append(rf)
        _names.append(name)
        _parents.append(_open[-2] if len(_open) > 1 else -1)
        _ns.append(_n)
        _ends.append(0)
        _starts.append(_clock() + _offset)

    def __exit__(self, *exc) -> bool:
        t = _clock() + _offset
        if _open:
            _ends[_open.pop()] = t
            rf = _ranges.pop()
            if rf is not None:
                rf.__exit__(*exc)
        return False


_RECORDER = _Recorder()


def span(name: str, n: int = -1):
    """A context over one piece of work named ``name`` (``n``: an integer
    it carries, such as a layer's index)."""
    global _name, _n, _skipped
    if not _on:
        return record_function(name) if _profiling() else _NULL
    if len(_names) >= LIMIT:
        _skipped += 1
        return record_function(name) if _profiling() else _NULL
    _name, _n = name, n
    return _RECORDER


def traced(name: str):
    """Decorate a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def ids(reqs: Iterable) -> None:
    """Record the ids of ``reqs`` (requests) on the innermost open span;
    nothing while the tracer is off."""
    if _on and _open:
        _ids[_open[-1]] = tuple(r.req_id for r in reqs)


def enabled() -> bool:
    return _on


def enable() -> None:
    """Record spans from now on, on the profiler's clock."""
    global _on, _offset
    # the tightest of a few paired reads: a preemption between two reads
    # would shift every span
    _, _offset = min((b - a, t - (a + b) // 2) for a, t, b in (
        (_clock(), time.time_ns(), _clock()) for _ in range(5)))
    _on = True


def disable() -> None:
    """Stop recording (spans open now still close into their rows)."""
    global _on
    _on = False


def reset() -> None:
    """Forget every recorded span and the count of skipped ones."""
    global _skipped
    for column in (_names, _open, _ranges):
        column.clear()
    for column in (_starts, _ends, _parents, _ns):
        del column[:]
    _ids.clear()
    _skipped = 0


def skipped() -> int:
    """Spans left out since :func:`reset` because ``LIMIT`` rows were
    kept."""
    return _skipped


def to_ns(perf_s: float) -> int:
    """A ``time.perf_counter()`` reading in ns on the tracer's clock."""
    return round(perf_s * 1e9) + _offset


def records() -> List[Span]:
    return [Span(*row, _ids.get(i), n) for i, (*row, n) in enumerate(
        zip(_names, _starts, _ends, _parents, _ns))]


def self_ns(spans: Sequence[Span]) -> List[int]:
    """Each span's ns less its children's, over a whole :func:`records`
    list (``parent`` indexes it)."""
    own = [s.end - s.start for s in spans]
    for s in spans:
        if s.end and s.parent >= 0:
            own[s.parent] -= s.end - s.start
    return own


def summary(spans: Optional[Sequence[Span]] = None, start: int = 0,
            end: Optional[int] = None) -> Dict[str, Tuple[int, float, float]]:
    """``{name: (count, total s, self s)}`` of the closed spans that lie in
    ``[start, end]`` (ns, profiler clock), out of a whole :func:`records`
    list (default: the tracer's own)."""
    spans = records() if spans is None else spans
    out: Dict[str, List] = {}
    for s, own in zip(spans, self_ns(spans)):
        if not s.end or s.start < start or (end is not None and s.end > end):
            continue
        row = out.setdefault(s.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (s.end - s.start) / 1e9
        row[2] += own / 1e9
    return {k: (n, t, o) for k, (n, t, o) in out.items()}
