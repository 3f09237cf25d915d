"""Prefix-caching benchmark on the port: TTFT under shared-system-prompt
load.

Twin of ``benchmarks/prefix_caching.py`` (no JAX). A stream of requests
that all begin with the same long system prompt followed by a short unique
user suffix; with ``prefix_caching=True`` the first request's prompt blocks
are committed to the refcounted cache and every later admission reserves
only the unique suffix and starts its prefill at the cached offset.

* **sim** — the reference's ``run_sim``, copied, on the port's copy of the
  simulator (**>= 2x lower mean warm TTFT** with caching).
* **real** — the port's ``Engine`` (paged pool: a hit aliases the cached
  blocks, no K/V is copied): a two-phase submit (donor, then the warm
  cohort), uncached against cached; greedy tokens identical, one prefix
  install per warm request; warm TTFT, hit rate and prefill tokens saved.
  Each run reports its dispatches and each kernel wrapper's launches.

    PYTHONPATH=src python -m benchmarks.torch_prefix_caching --device cpu --smoke
    python -m benchmarks.torch_prefix_caching --full        # on the card

On the CPU the engine serves the reference's smoke config (f32,
``vocab_size`` 2048) through the kernels' plain versions; ``--full`` serves
the published widths in f32. The section merges into ``BENCH_torch.json``
(or ``--json``).
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
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import report
from repro_torch.serving.simulator import CostModel, simulate


def _stats(finished, core=None):
    """Warm-request TTFT split + cache counters for one run. The cold-start
    request (earliest arrival) is excluded from the warm set — it is the
    miss that populates the cache in both variants."""
    cold = min(finished, key=lambda r: r.arrival_time)
    warm = [r for r in finished if r is not cold]
    ttft = np.array([r.first_token_time - r.arrival_time for r in warm])
    rep = report("fcfs", finished)
    return {
        "n_requests": len(finished),
        "ttft_mean_warm_s": float(ttft.mean()),
        "ttft_p99_warm_s": float(np.percentile(ttft, 99)),
        "ttft_cold_s": float(cold.first_token_time - cold.arrival_time),
        "prefix_hit_rate": float(rep.prefix_hit_rate),
        "prefill_tokens_saved": float(rep.prefill_tokens_saved),
        "throughput_tok_s": rep.throughput_tok_s,
    }


def _row(label, s):
    print(f"  {label:10s} warm ttft mean={s['ttft_mean_warm_s'] * 1e3:8.2f} ms"
          f"  p99={s['ttft_p99_warm_s'] * 1e3:8.2f} ms  "
          f"hit_rate={s['prefix_hit_rate']:5.2f}  "
          f"saved={s['prefill_tokens_saved']:9.0f} tok  "
          f"tput={s['throughput_tok_s']:8.1f} tok/s")


# ---------------------------------------------------------------- simulator
def run_sim(*, n: int = 32, shared_words: int = 1024, unique_words: int = 63,
            out_len: int = 32, gap_s: float = 0.7) -> dict:
    """Discrete-event comparison (A100-scale cost constants). Arrivals are
    spaced so each prompt's prefill commits before the next admission — the
    steady-state regime where every request after the first is a hit."""
    prompt_len = 1 + shared_words + unique_words        # CLS + words
    prefix = " ".join(f"sys{i}" for i in range(shared_words))

    def reqs():
        return [Request(i, prefix + " " +
                        " ".join(f"u{i}w{j}" for j in range(unique_words)),
                        i * gap_s, prompt_len, out_len) for i in range(n)]

    out = {"shared_prompt_tokens": shared_words}
    for label, caching in (("uncached", False), ("cached", True)):
        fin = simulate(reqs(), Scheduler(policy=fcfs(), max_batch=8),
                       cost=CostModel(),
                       config=ServingConfig(prefix_caching=caching))
        assert len(fin) == n
        out[label] = _stats(fin)
        _row(label, out[label])
    speedup = (out["uncached"]["ttft_mean_warm_s"]
               / out["cached"]["ttft_mean_warm_s"])
    out["warm_ttft_speedup"] = speedup
    # the acceptance bar: >= 2x lower mean TTFT for shared-prefix
    # requests in sim mode
    assert speedup >= 2.0, f"warm-TTFT speedup {speedup:.2f}x < 2x"
    print(f"  [sim] warm mean TTFT {speedup:.1f}x lower with prefix caching")
    return out


# -------------------------------------------------------------- real engine
def run_real(*, arch: str = "llama3_2_3b", n_warm: int = 6,
             shared_words: int = 40, unique_words: int = 8,
             prompt_len: int = 64, out_len: int = 6, full: bool = False,
             device: DeviceLike = "cuda", params=None) -> dict:
    """Wall-clock comparison on the port's engine.

    Two-phase submits (donor first, then the warm cohort) make the hit
    pattern deterministic regardless of host speed. Asserts token-for-token
    identical greedy outputs cached vs uncached. ``params`` (on
    ``device``) replace the seeded random weights."""
    dev = resolve_device(device)
    cfg = engine_config(arch, full, "float32")
    if params is None:
        params = tfm.init_params(cfg, 0, device=dev)
    prefix = " ".join(f"sys{i}" for i in range(shared_words))
    wc = 1 + shared_words + unique_words

    def run(caching):
        eng = Engine(cfg, params,
                     Scheduler(policy=fcfs(), max_batch=n_warm + 1),
                     cache_len=2 * prompt_len, prompt_len=prompt_len,
                     record_tokens=True,
                     config=ServingConfig(prefix_caching=caching),
                     device=dev)
        eng.warmup()
        before = launches()
        eng.submit([Request(0, prefix + " donor tail words", 0.0, wc,
                            out_len)])
        eng.run()
        eng.submit([Request(10 + i, prefix + " " +
                            " ".join(f"u{i}w{j}" for j in range(unique_words)),
                            0.0, wc, out_len) for i in range(n_warm)])
        eng.run()
        assert len(eng.finished) == n_warm + 1
        return eng, launches_since(before)

    out = {"shared_words": shared_words, **width_keys(arch, cfg, full)}
    tokens = {}
    for label, caching in (("uncached", False), ("cached", True)):
        eng, counts = run(caching)
        tokens[label] = {r.req_id: r.generated_tokens for r in eng.finished}
        out[label] = _stats(eng.finished)
        out[label].update(
            prefix_installs=eng.backend.prefix_installs,
            prefix_tokens_copied=eng.backend.prefix_tokens_copied,
            prefill_dispatches=eng.backend.prefill_dispatches,
            extend_dispatches=eng.backend.extend_dispatches,
            launches=counts)
        _row(label, out[label])
    out["tokens"] = tokens["cached"]
    out["identical_outputs"] = tokens["uncached"] == tokens["cached"]
    assert out["identical_outputs"], (
        f"cached decode diverged from uncached: {tokens}")
    assert out["cached"]["prefix_installs"] == n_warm
    print("  [real] cached outputs identical to uncached ✓")
    return out


def run(*, smoke: bool = False, full: bool = False,
        device: DeviceLike = "cuda", mode: str = "both") -> dict:
    """The sections ``mode`` names, at the reference's default or
    ``--smoke`` sizes."""
    results = {}
    if mode in ("sim", "both"):
        print("simulator (A100-scale constants):")
        kw = (dict(n=8, shared_words=512, unique_words=31) if smoke
              else {})
        results["sim"] = run_sim(**kw)
    if mode in ("real", "both"):
        print(f"real engine ({'published' if full else 'smoke'} width, "
              f"f32, wall clock):")
        kw = (dict(n_warm=3, shared_words=20, unique_words=6, prompt_len=32)
              if smoke else {})
        results["real"] = run_real(full=full, device=device, **kw)

    for mode_name, res in results.items():
        # CI smoke contract: the cache counters and both TTFT axes exist
        for variant in ("uncached", "cached"):
            assert {"ttft_mean_warm_s", "ttft_p99_warm_s", "prefix_hit_rate",
                    "prefill_tokens_saved"} <= set(res[variant])
        if mode_name == "sim":
            speedup = (res["uncached"]["ttft_mean_warm_s"]
                       / res["cached"]["ttft_mean_warm_s"])
            derived = (f"warm-request mean TTFT {speedup:.1f}x lower than "
                       f"uncached "
                       f"(hit_rate={res['cached']['prefix_hit_rate']:.2f})")
        else:
            derived = (f"outputs identical cached vs uncached; "
                       f"{res['cached']['prefill_tokens_saved']:.0f} prefill "
                       f"tokens saved "
                       f"(hit_rate={res['cached']['prefix_hit_rate']:.2f})")
        emit(f"prefix_caching_{mode_name}",
             res["cached"]["ttft_mean_warm_s"] * 1e6, derived)
    return results


def section(results: dict) -> dict:
    """The reference's ``prefix_caching`` section keys, then the sim and
    real sections whole."""
    out = dict(results)
    if "sim" in results:
        s = results["sim"]
        out.update({
            "warm_ttft_speedup": s["warm_ttft_speedup"],
            "cached_warm_ttft_s": s["cached"]["ttft_mean_warm_s"],
            "uncached_warm_ttft_s": s["uncached"]["ttft_mean_warm_s"],
            "hit_rate": s["cached"]["prefix_hit_rate"],
            "prefill_tokens_saved": s["cached"]["prefill_tokens_saved"],
        })
    real = results.get("real", {})
    out.update(real_identical_outputs=real.get("identical_outputs"),
               width=real.get("width"))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="benchmarks.torch_prefix_caching")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI config: prove both modes run, the sim "
                         "speedup holds, and real outputs match")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (on the card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="merge the section into this file instead of "
                    "BENCH_torch.json at the repo root")
    ap.add_argument("--mode", choices=("sim", "real", "both"), default="both")
    args = ap.parse_args(argv)
    resolve_device(args.device)           # no card: fail before any work
    t0 = time.perf_counter()
    results = run(smoke=args.smoke, full=args.full, device=args.device,
                  mode=args.mode)
    payload = {**section(results), **section_meta(args.device, None),
               "wall_s": time.perf_counter() - t0}
    record_torch_bench("prefix_caching", payload,
                       args.json or BENCH_TORCH_JSON)
    return payload


if __name__ == "__main__":
    main()
