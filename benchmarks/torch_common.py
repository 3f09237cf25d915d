"""Shared infrastructure of the port's benchmark twins: sized settings,
in-process caches, the predictor trainer at a named width, and the
``BENCH_torch.json`` section merge, and the serving-benchmark runner.

The twin of ``benchmarks/common.py`` for ``benchmarks/torch_*.py``. It
imports the port (``repro_torch``) and neither JAX nor the JAX package, so
the twins run on a machine with a card and no JAX. Every table benchmark
goes through :func:`get_predictor`, so a predictor trained for Table II is
reused by Tables III/IV and the simulator studies without retraining.

FAST mode (default) uses reduced corpus/epoch sizes; ``REPRO_BENCH_FULL=1``
restores the paper-scale protocol, as in the reference. Predictors train
on an explicit ``device`` (``"cuda"`` raises without a card) at one of two
widths (``PREDICTOR_WIDTHS``): ``mini``, the reference benchmarks' default
``PredictorConfig()``, or ``pars_bert_base``, the paper's BERT-base.

Serving benchmarks on the copied simulator declare a :class:`ServingBench`
and delegate their ``main`` to :func:`bench_main`, as in the reference; their
sections ran on no device and say so (``"device": "simulator"``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple

from repro_torch.configs import get_config, get_smoke_config, pars_bert_base
from repro_torch.core.predictor import (HashTokenizer, TrainSettings,
                                        evaluate_tau, train_predictor)
from repro_torch.data.synthetic import MODELS, make_corpus, sample_lengths
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_decode.ops import (paged_decode_attention,
                                                  ring_decode_attention)
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.kernels.rwkv6_chunk.ops import linear_attention

FAST = os.environ.get("REPRO_BENCH_FULL", "0") != "1"

#: the predictor widths a twin trains at
PREDICTOR_WIDTHS = ("mini", "pars_bert_base")


@dataclass(frozen=True)
class BenchScale:
    n_train: int
    n_test: int
    epochs: int
    pairs_per_epoch: int
    burst: int
    sweep_requests: int


def scale() -> BenchScale:
    if FAST:
        return BenchScale(n_train=1500, n_test=400, epochs=2,
                          pairs_per_epoch=2560, burst=2000,
                          sweep_requests=600)
    return BenchScale(n_train=8000, n_test=1500, epochs=5,
                      pairs_per_epoch=6400, burst=2000, sweep_requests=2000)


@functools.lru_cache(maxsize=None)
def corpus(dataset: str, split: str):
    sc = scale()
    if split == "train":
        return make_corpus(dataset, sc.n_train, seed=0)
    return make_corpus(dataset, sc.n_test, seed=424242)


@functools.lru_cache(maxsize=None)
def lengths(dataset: str, split: str, model: str):
    run_seed = 0 if split == "train" else 9
    return sample_lengths(corpus(dataset, split), model, run_seed=run_seed)


def get_predictor(dataset: str, model: str, method: str = "pairwise",
                  backbone: str = "bert", delta: float = -1.0, *,
                  device: DeviceLike = "cuda", width: str = "mini"):
    """Train (or fetch cached) predictor. delta=-1 → the model's paper δ
    (resolved before the cache, so an explicit paper δ reuses it)."""
    if delta < 0:
        delta = MODELS[model].delta
    if width not in PREDICTOR_WIDTHS:
        raise ValueError(f"unknown predictor width {width!r}; "
                         f"one of {PREDICTOR_WIDTHS}")
    return _trained(dataset, model, method, backbone, delta,
                    str(resolve_device(device)), width)


@functools.lru_cache(maxsize=None)
def _trained(dataset, model, method, backbone, delta, device, width):
    sc = scale()
    st = TrainSettings(method=method, epochs=sc.epochs,
                       pairs_per_epoch=sc.pairs_per_epoch, delta=delta)
    tokenizer, pcfg = None, None
    if width == "pars_bert_base":
        pcfg = dataclasses.replace(pars_bert_base.CONFIG, backbone=backbone)
        tokenizer = HashTokenizer(vocab_size=pcfg.vocab_size,
                                  max_len=pcfg.max_len)
    return train_predictor(corpus(dataset, "train").prompts,
                           lengths(dataset, "train", model),
                           backbone=backbone, settings=st,
                           tokenizer=tokenizer, pcfg=pcfg, device=device,
                           log_fn=lambda line: print(
                               f"{width} {dataset}/{model} δ={delta}: "
                               f"{line}", flush=True))


def tau_of(pred, dataset: str, model: str) -> float:
    return evaluate_tau(pred, corpus(dataset, "test").prompts,
                        lengths(dataset, "test", model))


def emit(name: str, us_per_call: float, derived: str) -> None:
    """The repo-wide CSV row convention: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.1f},{derived}")


#: the device label of a section that ran the simulator only (no device)
SIMULATOR = "simulator"
#: the device label of a section derived from traced steps, measured on no
#: device (the roofline)
DERIVED = "derived"


def device_label(device: DeviceLike) -> str:
    """What a section ran on: for a card, its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"); ``SIMULATOR``
    for the simulator; ``DERIVED`` for numbers derived from traced steps;
    else "cpu"."""
    if device in (SIMULATOR, DERIVED):
        return device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def section_meta(device: DeviceLike, width) -> dict:
    """The keys every ``BENCH_torch.json`` section carries: the device it
    ran on (``SIMULATOR`` where it ran none), the benchmark scale and the
    predictor width (None where the bench trains no predictor)."""
    return {"device": device_label(device),
            "scale": dataclasses.asdict(scale()), "predictor": width}


def section_name(bench: str, width=None) -> str:
    """A bench's section in ``BENCH_torch.json``: its name at the mini
    width (or where it trains no predictor), ``<name>@<width>`` at
    another, so that one file holds both widths' tables."""
    return bench if width in (None, "mini") else f"{bench}@{width}"


#: every kernel wrapper of the port, whose launches the engine twins report
KERNELS = (flash_attention, paged_decode_attention, ring_decode_attention,
           linear_attention)


def launches() -> dict:
    """Each kernel wrapper's launch count so far, by wrapper name."""
    return {k.__name__: k.launches for k in KERNELS}


def launches_since(before: dict) -> dict:
    """Each wrapper's launches since ``before`` (a :func:`launches`)."""
    return {k: v - before[k] for k, v in launches().items()}


def engine_config(arch: str, full: bool, dtype: Optional[str] = None):
    """The served model of an engine twin: the published config (in
    ``dtype`` where given, else its own), or the reference benches' smoke
    config in f32 with ``vocab_size`` 2048."""
    if full:
        cfg = get_config(arch)
        return cfg.replace(dtype=dtype) if dtype else cfg
    return get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)


def width_keys(arch: str, cfg, full: bool) -> dict:
    """The section keys that say at which width an engine twin served."""
    return dict(arch=arch, width="published" if full else "smoke",
                dtype=cfg.dtype, num_layers=cfg.num_layers,
                d_model=cfg.d_model, vocab_size=cfg.vocab_size)


def combo(dataset: str, model: str) -> str:
    """A (dataset, model) cell's key in a JSON section."""
    return f"{dataset}/{model}"


BENCH_TORCH_JSON = Path(__file__).resolve().parent.parent / "BENCH_torch.json"


def _strict(value):
    """``value`` with every non-finite float (a report's NaN counters)
    replaced by None, so the file is strict JSON."""
    if isinstance(value, dict):
        return {k: _strict(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_strict(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def record_torch_bench(section: str, payload: dict,
                       path=BENCH_TORCH_JSON) -> None:
    """Merge one twin's section into ``path`` (the repo-root
    ``BENCH_torch.json`` by default; created on first write, sections keyed
    by benchmark name so re-runs overwrite their own entry only)."""
    path = Path(path)
    data = json.loads(path.read_text()) if path.exists() else {}
    data[section] = _strict(payload)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2, sort_keys=True,
                               allow_nan=False) + "\n")


# -------------------------------------------------------- serving-bench runner
@dataclass(frozen=True)
class ServingBench:
    """One serving benchmark, declaratively (the reference's runner).

    ``run(args)`` does the actual work (acceptance assertions included) and
    returns the full results dict; ``section(results)`` reduces it to the
    ``BENCH_torch.json`` payload; ``headline(results)`` yields the
    ``(us_per_call, derived)`` pair(s) for the repo-wide CSV row convention;
    ``add_args`` hooks extra benchmark-specific flags onto the shared
    parser."""
    name: str
    run: Callable[[argparse.Namespace], dict]
    section: Callable[[dict], dict]
    headline: Optional[Callable[[dict], Tuple]] = None
    add_args: Optional[Callable[[argparse.ArgumentParser], None]] = None
    smoke_help: str = "tiny CI config: prove the acceptance bars hold"


def bench_args(bench: ServingBench, argv=None) -> argparse.Namespace:
    """``bench``'s command line: ``--smoke`` / ``--json`` / ``--seed`` and
    its own flags."""
    ap = argparse.ArgumentParser(prog=f"benchmarks.torch_{bench.name}")
    ap.add_argument("--smoke", action="store_true", help=bench.smoke_help)
    ap.add_argument("--json", default=None,
                    help="merge the section into this file instead of "
                    "BENCH_torch.json at the repo root")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (determinism knob)")
    if bench.add_args is not None:
        bench.add_args(ap)
    return ap.parse_args(argv)


def run_serving_bench(bench: ServingBench, args: argparse.Namespace) -> dict:
    """Run ``bench`` and print its CSV rows; returns its
    ``BENCH_torch.json`` section (labelled ``SIMULATOR``, with its wall
    seconds)."""
    t0 = time.perf_counter()
    results = bench.run(args)
    if bench.headline is not None:
        rows = bench.headline(results)
        # one (name, us, derived) row or a list of them
        if rows and not isinstance(rows[0], (tuple, list)):
            rows = [rows]
        for row in rows:
            emit(*row)
    return {**bench.section(results), **section_meta(SIMULATOR, None),
            "wall_s": time.perf_counter() - t0}


def bench_main(bench: ServingBench, argv=None) -> dict:
    """The one arg-parse/emit/record path every simulator serving twin
    shares: merges its section into ``BENCH_torch.json`` (or ``--json``)."""
    args = bench_args(bench, argv)
    section = run_serving_bench(bench, args)
    record_torch_bench(bench.name, section, args.json or BENCH_TORCH_JSON)
    return section


#: The simulator serving twins (``benchmarks/torch_<name>.py``), each
#: exposing ``BENCH`` and a ``main(argv)`` delegating to :func:`bench_main`.
SERVING_BENCHES = ("router", "iterative_rank", "fault_tolerance",
                   "workload_harness")
