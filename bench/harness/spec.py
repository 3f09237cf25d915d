"""The benchmark is driven by data: ``BENCHMARK.json`` names each cell, and
the harness finds what belongs to it by name.

* ``bench/configs/<config>.json``: the model (the program's
  ``ModelConfig`` fields), the engine's settings, the predictor, the
  limits of the numbers ``correct`` compares, what was assumed, and the
  architecture (``"arch"``, ``lm`` where absent);
* ``bench/archs/<arch>.py``: what the harness knows of an architecture,
  as functions: ``program_config(cfg_json)``, ``make_params(cfg, seed,
  device)``, the reference's ``logits(params, model, group, row, own,
  segments, positions, precision, probe=None)``, ``tokens_flops(model,
  positions)`` and ``decode_bound_s(model, positions, block)`` (one
  decode step's attention over all layers);
* ``bench/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator (``bench/harness/traffic.py``);
* ``bench/cells/<cell>.json`` (optional): what is the cell's own, such as
  a burst mix's interval;
* ``bench/metrics/<metric>.py``: one reader per metric, ``read(ctx)``,
  returning a number or None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    arch: ModuleType
    mix: dict
    own: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(name: str, bench: Optional[dict] = None,
         root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = bench or load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    own_path = root / "bench" / "cells" / f"{name}.json"
    config = load_json(root / "bench" / "configs" / f"{w['config']}.json")
    return Cell(name=name, chips=w["chips"], config=config,
                arch=arch(arch_name(config), root),
                mix=load_json(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                own=load_json(own_path) if own_path.exists() else {},
                end_to_end=metrics_of(bench["end_to_end"], name),
                per_layer=per_layer_of(bench, name))


def metrics_of(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> List[dict]:
    """Per-layer metrics of a cell: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in metrics_of(bench["end_to_end"], cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


_READERS: Dict[str, Callable] = {}


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    if str(path) not in _READERS:
        spec = importlib.util.spec_from_file_location(
            "bench.metrics." + metric.replace(".", "__"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[str(path)] = mod.read
    return _READERS[str(path)]


_ARCHS: Dict[str, ModuleType] = {}


def arch_name(config: dict) -> str:
    """The architecture a configuration file names (``lm`` where none)."""
    return config.get("arch", "lm")


def arch(name: str, root: Path = ROOT) -> ModuleType:
    """The module ``bench/archs/<name>.py``."""
    path = root / "bench" / "archs" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no architecture {name!r}: {path} is "
                                f"missing")
    if str(path) not in _ARCHS:
        spec = importlib.util.spec_from_file_location(
            "bench.archs." + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ARCHS[str(path)] = mod
    return _ARCHS[str(path)]
