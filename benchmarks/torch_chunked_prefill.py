"""Chunked-prefill benchmark on the port: decode tail latency under a
long-prompt burst.

Twin of ``benchmarks/chunked_prefill.py`` (no JAX). A pool of short
background requests is admitted at t=0 and decodes steadily; a burst of
long prompts arrives while they are mid-generation. Unchunked, the burst's
prefill runs inside one step and every background decode stalls for it;
with ``prefill_chunk_tokens`` set the burst streams into the KV cache
across many mixed steps.

* **sim** — the reference's ``run_sim``, copied, on the port's copy of the
  simulator.
* **real** — the port's ``Engine``: the burst's arrival calibrated from
  the measured decode rate, unchunked against chunked, background ITL
  p50/p99/max from recorded per-token times, background p99 TTFT, the
  burst's mean TTFT and the continuation-chunk dispatches; the two runs'
  greedy tokens must be identical. Each run reports its dispatches and
  each kernel wrapper's launches.

    PYTHONPATH=src python -m benchmarks.torch_chunked_prefill --device cpu --smoke
    python -m benchmarks.torch_chunked_prefill --full       # on the card

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
from repro_torch.serving.metrics import itl_samples
from repro_torch.serving.simulator import CostModel, simulate

BURST_ID0 = 1000      # req_ids >= this are burst (long-prompt) requests


def _stats(finished):
    """Background ITL percentiles + TTFT split for one run."""
    bg = [r for r in finished if r.req_id < BURST_ID0]
    burst = [r for r in finished if r.req_id >= BURST_ID0]
    itl = itl_samples(bg)
    ttft_bg = np.array([r.first_token_time - r.arrival_time for r in bg])
    ttft_burst = np.array([r.first_token_time - r.arrival_time
                           for r in burst])
    return {
        "n_background": len(bg), "n_burst": len(burst),
        "itl_p50_s": float(np.percentile(itl, 50)),
        "itl_p99_s": float(np.percentile(itl, 99)),
        "itl_max_s": float(itl.max()),
        "ttft_p99_bg_s": float(np.percentile(ttft_bg, 99)),
        "ttft_mean_burst_s": float(ttft_burst.mean()),
    }


def _row(label, s):
    print(f"  {label:10s} itl p50={s['itl_p50_s'] * 1e3:8.2f} ms  "
          f"p99={s['itl_p99_s'] * 1e3:8.2f} ms  "
          f"max={s['itl_max_s'] * 1e3:8.2f} ms  "
          f"burst ttft={s['ttft_mean_burst_s']:6.2f} s")


# ---------------------------------------------------------------- simulator
def run_sim(*, n_bg: int = 8, bg_len: int = 80, n_burst: int = 4,
            burst_prompt: int = 4000, chunk: int = 256) -> dict:
    """Discrete-event comparison (A100-scale cost constants).

    ``bg_len`` is sized so the unchunked burst stall (one giant gap per
    background request) sits inside the p99 of its ~``bg_len`` gaps."""
    def reqs():
        bg = [Request(i, f"bg{i}", 0.0, 8, bg_len) for i in range(n_bg)]
        burst = [Request(BURST_ID0 + i, f"long{i}", 1.0, burst_prompt, 8)
                 for i in range(n_burst)]
        return bg + burst

    out = {"chunk_tokens": chunk}
    for label, c in (("unchunked", None), ("chunked", chunk)):
        fin = simulate(reqs(), Scheduler(policy=fcfs(), max_batch=32),
                       cost=CostModel(),
                       config=ServingConfig(prefill_chunk_tokens=c,
                                            record_token_times=True))
        assert len(fin) == n_bg + n_burst
        out[label] = _stats(fin)
        _row(label, out[label])
    return out


# -------------------------------------------------------------- real engine
def run_real(*, arch: str = "llama3_2_3b", n_bg: int = 3, bg_len: int = 60,
             n_burst: int = 6, chunk: int = 16, prompt_len: int = 128,
             burst_at_token: int = 10, full: bool = False,
             device: DeviceLike = "cuda", params=None) -> dict:
    """Wall-clock comparison on the port's engine.

    The burst's arrival is calibrated from the measured decode rate so the
    background requests are mid-generation when the long prompts land,
    regardless of host speed. Runs unchunked and chunked over identical
    request sets and asserts the generated tokens match token-for-token.
    ``params`` (on ``device``) replace the seeded random weights.
    """
    dev = resolve_device(device)
    cfg = engine_config(arch, full, "float32")
    if params is None:
        params = tfm.init_params(cfg, 0, device=dev)

    def reqs(burst_t):
        bg = [Request(i, f"short prompt {i}", 0.0, 4, bg_len)
              for i in range(n_bg)]
        burst = [Request(BURST_ID0 + i,
                         " ".join(f"w{i}x{j}" for j in range(prompt_len - 2)),
                         burst_t, prompt_len, 6) for i in range(n_burst)]
        return bg + burst

    # the reference's 2 * prompt_len + 2 * bg_len, rounded up to whole
    # 16-token blocks: its paged engine refuses a cache_len that is not a
    # multiple of the block size, so the reference's own default sizes
    # (376) raise there (ROADMAP C4)
    cache_len = -(-(2 * prompt_len + 2 * bg_len) // 16) * 16

    def engine(c):
        eng = Engine(cfg, params,
                     Scheduler(policy=fcfs(), max_batch=n_bg + n_burst),
                     cache_len=cache_len,
                     prompt_len=prompt_len, record_tokens=True,
                     config=ServingConfig(prefill_chunk_tokens=c,
                                          record_token_times=True),
                     device=dev)
        eng.warmup()
        return eng

    # calibrate decode seconds/token on this host so the burst lands while
    # the background requests are mid-decode; the unchunked engine is
    # reused for its comparison run afterwards (greedy sampling, so the
    # advanced generator cannot change its outputs)
    engines = {"unchunked": engine(None), "chunked": engine(chunk)}
    cal = engines["unchunked"]
    before = launches()
    cal.submit([Request(0, "calibration", 0.0, 4, 30)])
    cal_fin = cal.run()[0]
    calibration = {"prefill_dispatches": cal.backend.prefill_dispatches,
                   "extend_dispatches": cal.backend.extend_dispatches,
                   "launches": launches_since(before)}
    s_per_tok = (cal_fin.finish_time - cal_fin.first_token_time) / 29
    cal.core.finished.clear()
    burst_t = burst_at_token * s_per_tok
    print(f"  [real] decode ≈ {s_per_tok * 1e3:.2f} ms/token → "
          f"burst at t={burst_t * 1e3:.1f} ms")

    out = {"chunk_tokens": chunk, "s_per_token": s_per_tok,
           "cache_len": cache_len, "calibration": calibration,
           **width_keys(arch, cfg, full)}
    tokens = {}
    for label, eng in engines.items():
        dispatches = (eng.backend.prefill_dispatches,
                      eng.backend.extend_dispatches)
        before = launches()
        eng.submit(reqs(burst_t))
        fin = eng.run()
        assert len(fin) == n_bg + n_burst
        tokens[label] = {r.req_id: r.generated_tokens for r in fin}
        out[label] = _stats(fin)
        out[label].update(
            prefill_dispatches=eng.backend.prefill_dispatches
            - dispatches[0],
            extend_dispatches=eng.backend.extend_dispatches - dispatches[1],
            launches=launches_since(before))
        _row(label, out[label])
    out["tokens"] = tokens["chunked"]
    out["identical_outputs"] = tokens["unchunked"] == tokens["chunked"]
    assert out["identical_outputs"], (
        f"chunked decode diverged from unchunked: {tokens}")
    print("  [real] chunked outputs identical to unchunked ✓")
    return out


def run(*, smoke: bool = False, full: bool = False,
        device: DeviceLike = "cuda", mode: str = "both",
        chunk=None) -> dict:
    """The sections ``mode`` names, at the reference's default or
    ``--smoke`` sizes (``chunk`` overrides ``prefill_chunk_tokens``)."""
    results = {}
    if mode in ("sim", "both"):
        print("simulator (A100-scale constants):")
        kw = (dict(n_bg=4, bg_len=60, n_burst=2) if smoke else {})
        if chunk:
            kw["chunk"] = chunk
        results["sim"] = run_sim(**kw)
    if mode in ("real", "both"):
        print(f"real engine ({'published' if full else 'smoke'} width, "
              f"f32, wall clock):")
        kw = (dict(n_bg=2, bg_len=40, n_burst=2, prompt_len=32, chunk=8)
              if smoke else {})
        if chunk:
            kw["chunk"] = chunk
        results["real"] = run_real(full=full, device=device, **kw)

    for mode_name, res in results.items():
        # CI smoke contract: both latency axes present in both variants
        for variant in ("unchunked", "chunked"):
            assert {"itl_p50_s", "itl_p99_s", "ttft_p99_bg_s",
                    "ttft_mean_burst_s"} <= set(res[variant])
        speedup = res["unchunked"]["itl_p99_s"] / res["chunked"]["itl_p99_s"]
        emit(f"chunked_prefill_{mode_name}",
             res["chunked"]["itl_p99_s"] * 1e6,
             f"p99 ITL {speedup:.1f}x lower than unchunked "
             f"(chunk={res['chunk_tokens']})")
    return results


def section(results: dict) -> dict:
    """The reference's ``chunked_prefill`` section keys, then the sim and
    real sections whole."""
    out = dict(results)
    if "sim" in results:
        s = results["sim"]
        out.update({
            "p99_itl_speedup": s["unchunked"]["itl_p99_s"]
            / s["chunked"]["itl_p99_s"],
            "chunked_p99_itl_s": s["chunked"]["itl_p99_s"],
            "unchunked_p99_itl_s": s["unchunked"]["itl_p99_s"],
            "chunk_tokens": s["chunk_tokens"],
        })
    real = results.get("real", {})
    out.update(real_identical_outputs=real.get("identical_outputs"),
               width=real.get("width"))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="benchmarks.torch_chunked_prefill")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI config: just prove both modes run and "
                         "emit TTFT + ITL percentiles")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (on the card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="merge the section into this file instead of "
                    "BENCH_torch.json at the repo root")
    ap.add_argument("--mode", choices=("sim", "real", "both"), default="both")
    ap.add_argument("--chunk", type=int, default=None,
                    help="override prefill_chunk_tokens in both modes")
    args = ap.parse_args(argv)
    resolve_device(args.device)           # no card: fail before any work
    t0 = time.perf_counter()
    results = run(smoke=args.smoke, full=args.full, device=args.device,
                  mode=args.mode, chunk=args.chunk)
    payload = {**section(results), **section_meta(args.device, None),
               "wall_s": time.perf_counter() - t0}
    record_torch_bench("chunked_prefill", payload,
                       args.json or BENCH_TORCH_JSON)
    return payload


if __name__ == "__main__":
    main()
