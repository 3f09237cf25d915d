"""Trip-count-aware HLO cost analysis.

XLA's built-in ``compiled.cost_analysis()`` counts each computation ONCE —
``while`` bodies (i.e. every ``lax.scan``: our layer stack, chunked attention,
linear-attention chunks) are under-counted by their trip count, which makes
an 80-layer model look 80× cheaper. This module re-derives per-device costs
from ``compiled.as_text()``:

* parses every computation's ops (shapes from each definition line),
* builds the call graph (while/fusion/call/conditional/map/reduce/sort/scatter),
* multiplies through ``backend_config={"known_trip_count"...}`` on while ops,
* FLOPs: 2·prod(result)·prod(contracted dims) per ``dot`` (+ rough elementwise
  count: 1 FLOP per output element of arithmetic ops),
* HBM traffic ≈ Σ bytes written per op (each produced buffer written once and
  read ≈ once downstream ⇒ traffic ≈ 2× produced bytes; parameters counted
  once). An approximation, but a *consistent* one across combos — documented
  in EXPERIMENTS.md §Roofline,
* collective payload bytes by kind, trip-count-weighted.

Validated against hand-computed matmul/scan cases in tests/test_hlo_cost.py.
"""
from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_DEF_RE = re.compile(r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_COMP_HDR_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*{\s*$")
_CALLEE_RE = re.compile(
    r"(?:body|calls|to_apply|branch_computations)=\{?%?([\w.\-,%\s]+)\}?")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')

ARITH_OPS = ("add", "subtract", "multiply", "divide", "maximum", "minimum",
             "exponential", "tanh", "rsqrt", "sqrt", "log", "power", "negate",
             "compare", "select", "and", "or", "convert", "cosine", "sine")
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
_SKIP_BYTES = ("parameter", "tuple", "get-tuple-element", "bitcast",
               "constant", "after-all", "partition-id", "replica-id")


def _shapes(text: str) -> List[Tuple[str, List[int]]]:
    out = []
    for dt, dims in _SHAPE_RE.findall(text):
        if dt in _DTYPE_BYTES:
            out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def _nbytes(shapes) -> int:
    total = 0
    for dt, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


def _nelems(shapes) -> int:
    total = 0
    for _, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n
    return total


@dataclass
class Op:
    name: str
    kind: str
    result_text: str
    rest: str


@dataclass
class Computation:
    name: str
    ops: List[Op] = field(default_factory=list)
    symbols: Dict[str, str] = field(default_factory=dict)  # name -> result text
    root: "Op" = None


def parse_computations(hlo: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur = None
    for line in hlo.splitlines():
        hdr = _COMP_HDR_RE.match(line.strip())
        if hdr and ("->" in line):
            cur = Computation(hdr.group(2))
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, rhs = m.group(2), m.group(3)
        # rhs = "<result shape(s)> <opcode>(operands...), attrs"
        km = re.search(r"\)?\s*([\w\-]+)\(", rhs)
        kind = km.group(1) if km else ""
        paren = rhs.find(kind + "(") if kind else -1
        result_text = rhs[:paren] if paren > 0 else rhs
        op = Op(name, kind, result_text, rhs)
        cur.ops.append(op)
        cur.symbols[name] = result_text
        if m.group(1):                      # ROOT marker
            cur.root = op
    return comps


# operands may carry inline type annotations, e.g.
# dot(f32[128,128]{1,0} %Arg_0.1, f32[128,128]{1,0} %Arg_1.2, …)
_OPERAND_TYPE = r"(?:[a-z0-9]+\[[^\]]*\](?:\{[^}]*\})?\s+)?"


def _dot_flops(op: Op, symbols: Dict[str, str]) -> float:
    res_elems = _nelems(_shapes(op.result_text))
    lhs_m = re.search(r"dot\((" + _OPERAND_TYPE + r")%?([\w.\-]+)", op.rest)
    cdims_m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.rest)
    if not lhs_m or not cdims_m:
        return 2.0 * res_elems                       # degenerate
    lhs_shape_text = lhs_m.group(1) or symbols.get(lhs_m.group(2), "")
    shp = _shapes(lhs_shape_text)
    if not shp:
        return 2.0 * res_elems
    dims = shp[0][1]
    contract = 1
    for c in cdims_m.group(1).split(","):
        if c and int(c) < len(dims):
            contract *= dims[int(c)]
    return 2.0 * res_elems * contract


_PURE_CONVERT_OPS = frozenset(
    {"parameter", "convert", "bitcast", "get-tuple-element", "tuple", ""})


def _is_pure_convert(comp: "Computation") -> bool:
    """True if the fused computation only casts dtypes (no real compute)."""
    kinds = {op.kind for op in comp.ops}
    return "convert" in kinds and kinds <= _PURE_CONVERT_OPS


def _dus_bytes(op: "Op", comp: "Computation") -> int:
    om = re.search(r"dynamic-update-slice\(" + _OPERAND_TYPE +
                   r"%?[\w.\-]+,\s*(" + _OPERAND_TYPE + r")%?([\w.\-]+)",
                   op.rest)
    if not om:
        return 0
    if om.group(1):                    # update operand's type is inline
        return _nbytes(_shapes(om.group(1)))
    return _nbytes(_shapes(comp.symbols.get(om.group(2), "")))


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes_written: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def traffic_bytes(self) -> float:
        return 2.0 * self.bytes_written

    def total_collective(self) -> float:
        return float(sum(self.collective_bytes.values()))


def analyze_hlo(hlo: str) -> CostSummary:
    comps = parse_computations(hlo)
    entry = next((n for n in comps
                  if re.search(r"^ENTRY", hlo.split(n)[0].splitlines()[-1]
                               if n in hlo else "")), None)
    # Robust entry detection: the computation declared on the ENTRY line.
    em = re.search(r"ENTRY\s+%?([\w.\-]+)", hlo)
    entry = em.group(1) if em else next(iter(comps))

    # local (single-visit) costs per computation
    local: Dict[str, CostSummary] = {}
    children: Dict[str, List[Tuple[str, float]]] = defaultdict(list)
    for cname, comp in comps.items():
        cs = CostSummary(collective_bytes={k: 0.0 for k in COLLECTIVE_OPS})
        for op in comp.ops:
            shapes = _shapes(op.result_text)
            if op.kind == "dot":
                cs.flops += _dot_flops(op, comp.symbols)
            elif op.kind in ARITH_OPS:
                cs.flops += _nelems(shapes)
            if op.kind == "dynamic-update-slice":
                # writes only the update operand's bytes, not the full buffer
                cs.bytes_written += _dus_bytes(op, comp) or _nbytes(shapes)
            elif op.kind == "fusion":
                fm = re.search(r"calls=%?([\w.\-]+)", op.rest)
                callee = comps.get(fm.group(1)) if fm else None
                dus_ops = ([o for o in callee.ops
                            if o.kind == "dynamic-update-slice"]
                           if callee is not None else [])
                if dus_ops:
                    # in-place buffer update (scan ys-stacking, cache writes,
                    # possibly wrapped in XLA:CPU's bf16<->f32 carry converts):
                    # the HBM write is the slice, not the full carried tensor
                    cs.bytes_written += (sum(_dus_bytes(o, callee)
                                             for o in dus_ops)
                                         or _nbytes(shapes))
                elif callee is not None and _is_pure_convert(callee):
                    # XLA:CPU has no native bf16 matmul and materializes f32
                    # copies of bf16 dot operands; on the TPU target the MXU
                    # consumes bf16 directly and these fusions do not exist —
                    # excluded so the memory term reflects the TPU roofline
                    # (EXPERIMENTS.md §Roofline caveats)
                    pass
                else:
                    cs.bytes_written += _nbytes(shapes)
            elif op.kind not in _SKIP_BYTES:
                cs.bytes_written += _nbytes(shapes)
            if op.kind in COLLECTIVE_OPS:
                b = _nbytes(shapes) * (2.0 if op.kind == "all-reduce" else 1.0)
                cs.collective_bytes[op.kind] += b
            # call graph edges
            trip = 1.0
            tm = _TRIP_RE.search(op.rest)
            if tm:
                trip = float(tm.group(1))
            cm = _CALLEE_RE.search(op.rest)
            if cm:
                for callee in re.split(r"[,\s]+", cm.group(1)):
                    callee = callee.strip().lstrip("%")
                    if callee and callee in comps:
                        # condition comps run trip+1 times; negligible — use trip
                        children[cname].append(
                            (callee, trip if op.kind == "while" else 1.0,
                             op.kind == "fusion"))
        local[cname] = cs

    # propagate multipliers from entry (memoized DFS; HLO call graphs are DAGs)
    memo: Dict[str, CostSummary] = {}

    def total(cname: str, depth=0) -> CostSummary:
        if cname in memo:
            return memo[cname]
        if depth > 64:
            return local.get(cname, CostSummary())
        cs = local.get(cname, CostSummary())
        agg = CostSummary(flops=cs.flops, bytes_written=cs.bytes_written,
                          collective_bytes=dict(cs.collective_bytes))
        for callee, mult, via_fusion in children.get(cname, ()):
            sub = total(callee, depth + 1)
            agg.flops += mult * sub.flops
            # ops inside a fusion share the fusion's single output write —
            # their intermediate "bytes written" never touch HBM
            if not via_fusion:
                agg.bytes_written += mult * sub.bytes_written
            for k, v in sub.collective_bytes.items():
                agg.collective_bytes[k] = agg.collective_bytes.get(k, 0.0) + mult * v
        memo[cname] = agg
        return agg

    return total(entry)
