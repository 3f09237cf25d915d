"""Roofline table of the port's dry-run: aggregate its JSON artifacts into
the per-(arch × shape × mesh) table (terms in seconds, bottleneck,
MODEL_FLOPS ratio) and a ``roofline`` section of ``BENCH_torch.json``.

Twin of ``benchmarks/roofline.py``. The numbers are derived from steps
traced on ``meta`` tensors over H100 datasheet rates, not measured: the
section's device is ``"derived"``. Artifacts come from:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --multi-pod both --out results/torch_dryrun
    PYTHONPATH=src python -m benchmarks.torch_roofline [--dir D] [--json F]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

from benchmarks.torch_common import (BENCH_TORCH_JSON, DERIVED, emit,
                                     record_torch_bench, section_meta)

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "results",
                           "torch_dryrun")
ROW_KEYS = ("arch", "shape", "mesh", "n_devices", "t_compute", "t_memory",
            "t_collective", "bottleneck", "useful_fraction",
            "memory_gb_per_device", "trace_s")


def load(dirpath: str = DEFAULT_DIR):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def run(dirpath: str = DEFAULT_DIR, json_path=BENCH_TORCH_JSON):
    """Print the table and record the section; returns it (None when the
    directory holds no artifacts)."""
    t0 = time.perf_counter()
    rows = load(dirpath)
    if not rows:
        print(f"# roofline: no dry-run artifacts in {dirpath} — run "
              "repro_torch.launch.dryrun first")
        emit("torch_roofline", 0.0, "no artifacts")
        return None
    print("# Roofline table (derived from traced dry-run steps; H100 "
          "datasheet rates)")
    print(f"{'arch':22s} {'shape':12s} {'mesh':10s} {'compute':>10s} "
          f"{'memory':>10s} {'collective':>11s} {'bottleneck':>11s} "
          f"{'useful':>7s} {'GB/dev':>8s}")
    counts, kept = {}, []
    for r in sorted(rows, key=lambda r: (r["mesh"], r["arch"], r["shape"])):
        if r.get("skipped"):
            continue
        counts[r["bottleneck"]] = counts.get(r["bottleneck"], 0) + 1
        kept.append({k: r.get(k) for k in ROW_KEYS})
        gb = r.get("memory_gb_per_device")
        print(f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:10s} "
              f"{r['t_compute'] * 1e3:9.2f}ms {r['t_memory'] * 1e3:9.2f}ms "
              f"{r['t_collective'] * 1e3:10.2f}ms {r['bottleneck']:>11s} "
              f"{r['useful_fraction']:7.1%} "
              f"{gb if gb is None else round(gb, 1):>8}")
    us = (time.perf_counter() - t0) * 1e6
    emit("torch_roofline", us, f"{len(kept)} combos; bottlenecks={counts}")
    section = {"combos": len(kept), "bottlenecks": counts, "rows": kept,
               "trace_s": sum(r["trace_s"] for r in kept),
               **section_meta(DERIVED, None),
               "wall_s": time.perf_counter() - t0}
    record_torch_bench("roofline", section, json_path)
    return section


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmarks.torch_roofline")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--json", default=str(BENCH_TORCH_JSON))
    args = ap.parse_args(argv)
    run(args.dir, args.json)


if __name__ == "__main__":
    main()
