"""Schema gate of the port's ``BENCH_torch.json``.

Every twin run by ``benchmarks/torch_run.py`` merges its section into
``BENCH_torch.json`` (see :func:`benchmarks.torch_common.record_torch_bench`).
This checker asserts that the file carries **all** expected sections with
their load-bearing keys non-null, and that every section names the device
it ran on. Sections at the paper's predictor width
(``<name>@pars_bert_base``) are held to the same keys. The simulator serving
twins (``SIMULATOR_SECTIONS``) ran on no device: their sections must say
``"simulator"``, and no other section may. The optional ``roofline``
section (``DERIVED_SECTIONS``) is derived from traced steps, not measured:
it must say ``"derived"``, and no other section may. With ``--card`` a
section measured on the CPU is refused, so a file that claims card numbers
holds only card numbers.

    python -m benchmarks.torch_check_bench [--card] [--path FILE]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from benchmarks.torch_common import (BENCH_TORCH_JSON, DERIVED,
                                     SERVING_BENCHES, SIMULATOR)

#: section name -> keys that must be present and non-null
REQUIRED_SECTIONS = {
    "table1": ("lengths", "variance"),
    "table2": ("tau", "pairwise_best_or_tied"),
    "table3": ("tau",),
    "table4": ("tau", "filtering_helps_or_ties"),
    "cross_model": ("cells", "worst_cross_speedup"),
    "pars_plus": ("avg_per_token_latency", "best_pars_plus_gain_vs_pars"),
    "prefill_admission": ("sequential", "bucketed", "speedup", "width"),
    # the reference's serving sections (benchmarks/check_bench.py), then
    # the engine twins' real halves and width
    "router": ("affinity", "skew"),
    "iterative_rank": ("mean_speedup_vs_static", "p99_speedup_vs_static",
                       "heavy_noise_vs_fcfs"),
    "fault_tolerance": ("crash_failover", "predictor_degradation",
                        "deadline_shed", "no_fault_parity"),
    "workload_harness": ("multitenant", "overload_shed", "starvation",
                         "rate_sweep", "routed"),
    "paged_decode": ("concurrency_ratio", "real_identical_outputs",
                     "real_prefix_tokens_copied", "kernel", "width"),
    "chunked_prefill": ("p99_itl_speedup", "chunked_p99_itl_s",
                        "unchunked_p99_itl_s", "real_identical_outputs",
                        "width"),
    "prefix_caching": ("hit_rate", "warm_ttft_speedup",
                       "prefill_tokens_saved", "real_identical_outputs",
                       "width"),
    "kernels": ("kernels",),
}
#: sections a file may hold but need not: section name -> its keys
OPTIONAL_SECTIONS = {
    "roofline": ("combos", "bottlenecks", "rows"),
}
#: the sections that ran the simulator only: labelled ``SIMULATOR``
SIMULATOR_SECTIONS = frozenset(SERVING_BENCHES)
#: the sections derived from traced steps, measured on no device
#: (``benchmarks/torch_roofline.py``): labelled ``DERIVED``
DERIVED_SECTIONS = frozenset({"roofline"})
#: keys every section carries (``section_meta``); ``predictor`` may be null
#: for the benches that train none
META_KEYS = ("device", "scale", "wall_s")


def check(path=BENCH_TORCH_JSON, card: bool = False) -> list:
    """Schema errors of ``path``: every required section present with its
    keys; every section, required or at another predictor width
    (``<name>@<width>``), with its own keys and the meta keys."""
    path = Path(path)
    if not path.exists():
        return [f"{path} missing — run benchmarks.torch_run first"]
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        return [f"{path} is not valid JSON: {e}"]
    errors = [f"section missing: {s}" for s in REQUIRED_SECTIONS
              if s not in data]
    known = {**REQUIRED_SECTIONS, **OPTIONAL_SECTIONS}
    for section, payload in data.items():
        bench = section.split("@")[0]
        if bench not in known:
            errors.append(f"unknown section: {section}")
            continue
        for key in (*known[bench], *META_KEYS):
            if payload.get(key) is None:
                errors.append(f"{section}.{key} missing or null")
        if "predictor" not in payload:
            errors.append(f"{section}.predictor missing")
        device = payload.get("device")
        if bench in SIMULATOR_SECTIONS and device != SIMULATOR:
            errors.append(f"{section} ran the simulator only, but its "
                          f"device says {device!r}")
        if bench not in SIMULATOR_SECTIONS and device == SIMULATOR:
            errors.append(f"{section} ran on a device, but says "
                          f"{SIMULATOR!r}")
        if bench in DERIVED_SECTIONS and device != DERIVED:
            errors.append(f"{section} is derived from traced steps, but "
                          f"its device says {device!r}")
        if bench not in DERIVED_SECTIONS and device == DERIVED:
            errors.append(f"{section} was measured, but says {DERIVED!r}")
        if card and device == "cpu":
            errors.append(f"{section} was measured on the CPU")
    return errors


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="benchmarks.torch_check_bench")
    ap.add_argument("--path", default=str(BENCH_TORCH_JSON))
    ap.add_argument("--card", action="store_true",
                    help="refuse sections measured on the CPU")
    args = ap.parse_args(argv)
    errors = check(args.path, card=args.card)
    if errors:
        print(f"{args.path} schema check FAILED ({len(errors)} error(s)):")
        for e in errors:
            print(f"  - {e}")
        sys.exit(1)
    data = json.loads(Path(args.path).read_text())
    devices = sorted({s["device"] for s in data.values()})
    print(f"{args.path} OK: {len(data)} sections ({', '.join(sorted(data))})"
          f" on {devices}")


if __name__ == "__main__":
    main()
