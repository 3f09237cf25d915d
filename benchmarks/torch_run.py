"""Benchmark runner of the port — one function per paper table/figure, the
twin of ``benchmarks/run.py`` for ``benchmarks/torch_*.py``.

    python -m benchmarks.torch_run                       # on the card
    python -m benchmarks.torch_run --only table2 cross_model \
        --predictor pars_bert_base
    PYTHONPATH=src python -m benchmarks.torch_run --device cpu --only table1

Each benchmark prints its table and a ``name,us_per_call,derived`` CSV row,
and merges its section (with the device it ran on, the scale, the
predictor width and its wall seconds) into ``BENCH_torch.json`` at the repo
root, or into ``--json``: under the bench's name at the mini width, under
``<name>@pars_bert_base`` at the paper's. ``--device`` defaults to
``cuda`` and raises without a card. On the card ``prefill_admission`` and
the engine twins (``paged_decode``, ``chunked_prefill``,
``prefix_caching``) serve the published widths (``--full``); on the CPU
the smoke config. The simulator serving twins (``SERVING_BENCHES``) run
on no device, and their sections say ``"simulator"``. ``--smoke`` passes
the reference's ``--smoke`` sizes to the serving and engine twins.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

from benchmarks.torch_common import (BENCH_TORCH_JSON, PREDICTOR_WIDTHS,
                                     SERVING_BENCHES, bench_args,
                                     record_torch_bench, run_serving_bench,
                                     section_meta, section_name)
from repro_torch.device import resolve_device

#: bench name (as in benchmarks/run.py) -> twin module
MODULES = {
    "table1": "torch_table1_variability",
    "table2": "torch_table2_rank_methods",
    "table3": "torch_table3_backbones",
    "table4": "torch_table4_filtering",
    "cross_model": "torch_cross_model",
    "pars_plus": "torch_pars_plus_ablation",
    "prefill_admission": "torch_prefill_admission",
    **{name: f"torch_{name}" for name in SERVING_BENCHES},
    "paged_decode": "torch_paged_decode",
    "chunked_prefill": "torch_chunked_prefill",
    "prefix_caching": "torch_prefix_caching",
    "kernels": "torch_kernel_bench",
}
BENCHES = tuple(MODULES)
#: the benches that train predictors (at ``--predictor``)
PREDICTOR_BENCHES = ("table2", "table3", "table4", "cross_model", "pars_plus")
#: the benches that serve on the port's engine (published width on a card)
ENGINE_BENCHES = ("paged_decode", "chunked_prefill", "prefix_caching")


def run_bench(name: str, device: str, width: str,
              smoke: bool = False) -> dict:
    """Run one bench; returns its ``BENCH_torch.json`` section."""
    mod = importlib.import_module(f"benchmarks.{MODULES[name]}")
    if name in SERVING_BENCHES:
        return run_serving_bench(mod.BENCH, bench_args(
            mod.BENCH, ["--smoke"] if smoke else []))
    t0 = time.perf_counter()
    full = resolve_device(device).type == "cuda"
    if name == "table1":
        results = mod.run()
    elif name == "prefill_admission":
        results = mod.run(device=device, full=full)
    elif name in ENGINE_BENCHES:
        results = mod.run(smoke=smoke, full=full, device=device)
    elif name == "kernels":
        results = mod.run(device=device)
    else:
        results = mod.run(device=device, predictor=width)
    return {**mod.section(results),
            **section_meta(device,
                           width if name in PREDICTOR_BENCHES else None),
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="benchmarks.torch_run")
    ap.add_argument("--only", nargs="*", default=None,
                    help=f"subset of {BENCHES}")
    ap.add_argument("--device", default="cuda",
                    help="where predictors train and the engine serves "
                    "(cuda raises without a card)")
    ap.add_argument("--predictor", default="mini", choices=PREDICTOR_WIDTHS,
                    help="predictor width: the reference benches' mini, or "
                    "the paper's BERT-base")
    ap.add_argument("--json", default=None,
                    help="merge the sections into this file instead of "
                    "BENCH_torch.json at the repo root")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's --smoke sizes for the serving "
                    "and engine twins")
    args = ap.parse_args(argv)
    selected = args.only or BENCHES
    unknown = [n for n in selected if n not in MODULES]
    if unknown:
        ap.error(f"unknown benches {unknown}; choose from {BENCHES}")
    resolve_device(args.device)           # no card: fail before any work

    t0 = time.perf_counter()
    sections, failures = {}, []
    for name in selected:
        print(f"\n{'=' * 72}\n== {name}\n{'=' * 72}", flush=True)
        try:
            sections[name] = run_bench(name, args.device, args.predictor,
                                       args.smoke)
        except Exception:
            failures.append(name)
            traceback.print_exc()
            continue
        width = args.predictor if name in PREDICTOR_BENCHES else None
        record_torch_bench(section_name(name, width), sections[name],
                           args.json or BENCH_TORCH_JSON)
    print(f"\ntotal benchmark wall time: {time.perf_counter() - t0:.0f}s")
    if failures:
        print(f"FAILED benches: {failures}")
        sys.exit(1)
    return sections


if __name__ == "__main__":
    main()
