"""Micro-bench: burst admission latency on the port's real path — sequential
per-request prefill against batched bucketed prefill (one ``forward_seq``
per prompt-length bucket per cycle).

Twin of ``benchmarks/prefill_admission.py`` on the port's ``Engine``, with
the reference's traffic: full-batch bursts of prompts of 2–27 words with
2–5 output tokens each, so every rep is one admission cycle, ``cache_len``
64, ``prompt_len`` 32, FCFS.

    PYTHONPATH=src python -m benchmarks.torch_prefill_admission --device cpu
    python -m benchmarks.torch_prefill_admission --full      # on the card

On the CPU it serves the smoke config in f32 with ``vocab_size`` 2048, as
the reference does, through the kernels' plain versions. ``--full`` serves
the published widths in bf16; on the card every prefill dispatch runs the
prefill kernel in each layer and every decode step the paged decode
kernel. Reported per mode: warm-up seconds (``Engine.warmup``: the kernel
build, which the reference spends compiling its shape grid), prefill
dispatches, wall seconds spent in admission, and each kernel wrapper's
launches during the mode's bursts.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks.torch_common import (BENCH_TORCH_JSON, emit, engine_config,
                                     launches, launches_since,
                                     record_torch_bench, section_meta,
                                     width_keys)
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine

CACHE_LEN, PROMPT_LEN = 64, 32


def _burst(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        words = int(rng.integers(2, 28))
        prompt = " ".join(f"w{rng.integers(0, 999)}" for _ in range(words))
        reqs.append(Request(i, prompt, 0.0, words + 1, int(rng.integers(2, 6))))
    return reqs


def run(batch: int = 8, reps: int = 4, arch: str = "llama3_2_3b", *,
        full: bool = False, device: DeviceLike = "cuda") -> dict:
    dev = resolve_device(device)
    # the published config (bf16), or the reference bench's smoke one
    cfg = engine_config(arch, full)
    params = tfm.init_params(cfg, 0, device=dev)
    results = {}
    for mode, bucketed in (("sequential", False), ("bucketed", True)):
        sched = Scheduler(policy=fcfs(), max_batch=batch)
        eng = Engine(cfg, params, sched, cache_len=CACHE_LEN,
                     prompt_len=PROMPT_LEN, bucketed=bucketed, device=dev)
        warm_s = eng.warmup()
        before = launches()
        t0 = time.perf_counter()
        for rep in range(reps):           # full-batch burst = 1 admission cycle
            eng.submit(_burst(batch, seed=rep))
            eng.run()
            assert len(eng.finished) == batch * (rep + 1)
        wall_s = time.perf_counter() - t0
        results[mode] = dict(
            dispatches=eng.backend.prefill_dispatches,
            prefill_s=eng.backend.prefill_seconds, warmup_s=warm_s,
            wall_s=wall_s, finished=len(eng.finished),
            tokens=sum(r.true_length for r in eng.finished),
            launches=launches_since(before))
        print(f"{mode:10s} warmup={warm_s:6.1f} s "
              f"dispatches={eng.backend.prefill_dispatches:3d} "
              f"(over {reps} bursts of {batch})  "
              f"admission={eng.backend.prefill_seconds * 1e3:8.1f} ms  "
              f"launches={results[mode]['launches']}")
        del eng
    seq, buk = results["sequential"], results["bucketed"]
    speedup = seq["prefill_s"] / max(buk["prefill_s"], 1e-9)
    print(f"bucketed admission: {seq['dispatches']}→{buk['dispatches']} "
          f"dispatches, {speedup:.2f}x faster")
    emit("prefill_admission", buk["prefill_s"] * 1e6 / (batch * reps),
         f"admission speedup {speedup:.2f}x "
         f"({seq['dispatches']}->{buk['dispatches']} dispatches)")
    results.update(**width_keys(arch, cfg, full), batch=batch, reps=reps,
                   cache_len=CACHE_LEN, prompt_len=PROMPT_LEN,
                   speedup=speedup)
    return results


def section(results: dict) -> dict:
    return dict(results)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="benchmarks.torch_prefill_admission")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--full", action="store_true",
                    help="published widths in bf16 (on the card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="merge the section into this file instead of "
                    "BENCH_torch.json at the repo root")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    results = run(args.batch, args.reps, args.arch, full=args.full,
                  device=args.device)
    payload = {**section(results), **section_meta(args.device, None),
               "wall_s": time.perf_counter() - t0}
    record_torch_bench("prefill_admission", payload,
                       args.json or BENCH_TORCH_JSON)
    return payload


if __name__ == "__main__":
    main()
