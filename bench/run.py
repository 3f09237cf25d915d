"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The last
line of standard output is the result as one JSON object; the lines before
it state the card, its power limit and clocks beside the window, and what
was served. With ``--trace 1`` the run reports the cell's per-layer
metrics, from counters over the window and a ``torch.profiler`` slice,
whose Chrome trace it writes into ``build/bench/``. The
numbers ``correct`` compares are the last lines of standard error and the
last key of the result; a line before them gives every reading the check
took. ``--control 1`` puts the control (the reference at the next
precision down, ``bench/harness/check.py``) in the program's place for the
check: its numbers are judged by the same limits, and ``correct`` has to
read false; the benchmark's own runs leave it off.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process drives the card; CPU thread pools only contend with it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def _smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "n/a"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "n/a"


def _forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness import cell as cell_mod, spec

    cell = spec.find(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = torch.cuda.get_device_name(0)
    smi = "name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu"
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; nvidia-smi before: {_smi(smi)}", flush=True)
    trace_path = None
    if args.trace:
        out_dir = ROOT / "build" / "bench"
        out_dir.mkdir(parents=True, exist_ok=True)
        trace_path = str(out_dir / f"{args.workload}-{args.seed}.trace.json")
    out = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                       T_START, log=lambda s: print(s, flush=True),
                       control=bool(args.control), trace_path=trace_path)
    print(f"nvidia-smi after the window: {_smi(smi)}")
    for line in out["info"]:
        print(line)
    if out["window"].trace_file:
        print(f"chrome trace: {out['window'].trace_file}")
    print("readings: " + json.dumps(out["readings"]))
    found = _forbidden_modules()
    if found:
        print(f"modules that may not load in a run: {found}; no result",
              file=sys.stderr)
        return 3
    result = out["result"]
    result["device"] = {"platform": "gpu", "kind": card, "count": 1,
                        "memory_peak_bytes": out["memory_peak_bytes"]}
    sl = out["window"].slice
    if args.trace and sl is not None:
        result["device"]["busy_s"] = sl.busy_s
        result["device"]["window_s"] = sl.window_s
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
