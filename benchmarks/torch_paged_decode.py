"""Paged-decode benchmark on the port: admitted concurrency under a fixed
KV budget.

Twin of ``benchmarks/paged_decode.py`` (no JAX), with its three sections:

* **sim** — the reference's ``run_sim``, copied, on the port's copy of the
  simulator: peak admitted concurrency full vs incremental reservation at
  the same ``kv_blocks`` budget (**>= 1.5x**), and grow-failure preemption
  recovering on a tight budget.
* **real** — the port's ``Engine``: greedy outputs identical paged (the
  paged decode kernel) vs contiguous (ring lanes, the ring decode kernel)
  on a shared-prefix workload, zero KV tokens copied on the paged
  prefix-cache hit path, and the grow/preempt counters live end to end on
  ``BlockAllocator(6, 16)``. Each run reports its dispatches and each
  kernel wrapper's launches.
* **kernel** — the port's paged decode kernel vs its plain version on a
  GQA shape with shuffled tables and an aliased block 0, at 2e-5 in f32
  (a timed row on the card only).

    PYTHONPATH=src python -m benchmarks.torch_paged_decode --device cpu --smoke
    python -m benchmarks.torch_paged_decode --full          # on the card

On the CPU the engine serves the reference's smoke config (f32,
``vocab_size`` 2048) through the kernels' plain versions; ``--full`` serves
the published widths in f32. The section merges into ``BENCH_torch.json``
(or ``--json``).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from benchmarks.torch_common import (BENCH_TORCH_JSON, emit, engine_config,
                                     launches, launches_since,
                                     record_torch_bench, section_meta,
                                     width_keys)
from benchmarks.torch_timing import cuda_ms
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_decode.ops import (
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.models import transformer as tfm
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import BlockAllocator
from repro_torch.serving.metrics import report
from repro_torch.serving.simulator import CostModel, simulate


# ---------------------------------------------------------------- simulator
def run_sim(*, n: int = 12, prompt_len: int = 16, out_len: int = 48,
            kv_blocks: int = 16, block_size: int = 16,
            tight_blocks: int = 6) -> dict:
    """Peak-concurrency comparison at a fixed budget, then a deliberately
    tight budget to exercise grow-failure preemption and recovery."""

    def reqs():
        return [Request(i, f"req {i} " + " ".join(f"w{j}" for j in range(8)),
                        0.0, prompt_len, out_len) for i in range(n)]

    def run(reservation, blocks):
        peak = {"running": 0}

        def probe(core, _now):
            peak["running"] = max(peak["running"],
                                  len(core.scheduler.running))

        fin = simulate(reqs(), Scheduler(policy=fcfs(), max_batch=n),
                       cost=CostModel(), kv_blocks=blocks,
                       block_size=block_size, on_step=probe,
                       config=ServingConfig(kv_reservation=reservation))
        assert len(fin) == n, "requests lost — scheduler deadlocked?"
        assert all(r.tokens_done == r.true_length for r in fin)
        return fin, peak["running"]

    out = {"kv_blocks": kv_blocks, "n_requests": n,
           "kv_demand_blocks_per_req": math.ceil((prompt_len + out_len)
                                                 / block_size)}
    for label in ("full", "incremental"):
        fin, peak = run(label, kv_blocks)
        rep = report("fcfs", fin)
        out[label] = {
            "peak_concurrency": peak,
            "makespan_s": rep.makespan,
            "avg_ttft_s": rep.avg_ttft,
            "grow_failures": rep.grow_failures,
            "grow_preemptions": rep.grow_preemptions,
        }
        print(f"  [sim] {label:11s} peak_concurrency={peak:3d}  "
              f"makespan={rep.makespan:7.2f} s  "
              f"grow_failures={rep.grow_failures}")
    # reservation-mode metrics contract: counters exist exactly when the
    # run reserved incrementally (NaN-safe aggregation otherwise)
    assert math.isnan(out["full"]["grow_failures"])
    assert not math.isnan(out["incremental"]["grow_failures"])
    ratio = (out["incremental"]["peak_concurrency"]
             / out["full"]["peak_concurrency"])
    out["concurrency_ratio"] = ratio
    assert ratio >= 1.5, f"admitted-concurrency ratio {ratio:.2f}x < 1.5x"
    print(f"  [sim] incremental admits {ratio:.1f}x more concurrent "
          f"requests at the same budget")

    # tight budget: growth *must* fail; preemption recovers, nothing hangs
    fin, _ = run("incremental", tight_blocks)
    rep = report("fcfs", fin)
    out["tight_budget"] = {
        "kv_blocks": tight_blocks,
        "grow_failures": rep.grow_failures,
        "grow_preemptions": rep.grow_preemptions,
        "preempted_requests": sum(1 for r in fin if r.preempt_count),
    }
    assert rep.grow_failures > 0, "tight budget never denied a grow"
    assert rep.grow_preemptions > 0, "denials never forced a preemption"
    print(f"  [sim] tight budget ({tight_blocks} blocks): "
          f"{rep.grow_failures:.0f} grow failures, "
          f"{rep.grow_preemptions:.0f} preemptions, all {n} finished")
    return out


# -------------------------------------------------------------- real engine
def _counters(eng: Engine, before: dict) -> dict:
    """A finished run's dispatches and each kernel wrapper's launches since
    ``before``."""
    return {"prefill_dispatches": eng.backend.prefill_dispatches,
            "extend_dispatches": eng.backend.extend_dispatches,
            "launches": launches_since(before)}


def run_real(*, arch: str = "llama3_2_3b", shared_words: int = 24,
             n_warm: int = 3, out_len: int = 4, prompt_len: int = 32,
             n_tight: int = 5, tight_out: int = 40, full: bool = False,
             device: DeviceLike = "cuda", params=None) -> dict:
    """Paged engine smoke: identity vs contiguous on a shared-prefix
    workload (zero-copy hits), then grow/preempt recovery end to end.
    ``params`` (on ``device``) replace the seeded random weights."""
    dev = resolve_device(device)
    cfg = engine_config(arch, full, "float32")
    if params is None:
        params = tfm.init_params(cfg, 0, device=dev)
    prefix = " ".join(f"sys{i}" for i in range(shared_words))
    out = {**width_keys(arch, cfg, full)}

    def shared_run(label, paged):
        eng = Engine(cfg, params,
                     Scheduler(policy=fcfs(), max_batch=n_warm + 1),
                     cache_len=2 * prompt_len, prompt_len=prompt_len,
                     paged=paged, record_tokens=True,
                     config=ServingConfig(prefix_caching=True), device=dev)
        eng.warmup()
        before = launches()
        eng.submit([Request(0, prefix + " donor tail", 0.0, prompt_len,
                            out_len)])
        eng.run()
        eng.submit([Request(10 + i, prefix + f" user{i} suffix", 0.0,
                            prompt_len, out_len) for i in range(n_warm)])
        eng.run()
        assert len(eng.finished) == n_warm + 1
        out[label] = _counters(eng, before)
        return eng

    t0 = time.perf_counter()
    contig = shared_run("contiguous", False)
    paged = shared_run("paged", True)
    out["wall_s"] = time.perf_counter() - t0
    toks = {p: {r.req_id: r.generated_tokens for r in e.finished}
            for p, e in (("contiguous", contig), ("paged", paged))}
    out["tokens"] = toks["paged"]
    out["identical_outputs"] = toks["contiguous"] == toks["paged"]
    assert out["identical_outputs"], (
        f"paged decode diverged from contiguous: {toks}")
    out["prefix_installs"] = paged.backend.prefix_installs
    out["prefix_tokens_copied"] = paged.backend.prefix_tokens_copied
    assert out["prefix_installs"] == n_warm
    assert out["prefix_tokens_copied"] == 0, "paged hit path copied KV"
    print(f"  [real] paged outputs identical to contiguous; "
          f"{n_warm} zero-copy prefix hits (0 tokens copied)")

    # incremental + tight budget on the real engine: recovery, live counters.
    # 14-word prompts land in the 16-token bucket, so demand = 16 +
    # tight_out tokens >= 3 blocks/request while admission reserves prompt
    # + one decode block = 2 — the rest *must* come from decode-time grows,
    # and 6 total blocks can't grow everyone at once
    reqs = [Request(i, f"r{i} " + " ".join(f"w{j}" for j in range(13)), 0.0,
                    16, tight_out) for i in range(n_tight)]
    eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=n_tight),
                 cache_len=48, prompt_len=16, allocator=BlockAllocator(6, 16),
                 record_tokens=True,
                 config=ServingConfig(kv_reservation="incremental"),
                 device=dev)
    before = launches()
    eng.submit(reqs)
    fin = eng.run()
    assert len(fin) == n_tight
    assert all(r.tokens_done == r.true_length for r in fin)
    rep = report("fcfs", fin)
    out["tight_budget"] = {"grow_failures": rep.grow_failures,
                           "grow_preemptions": rep.grow_preemptions,
                           "tokens": {r.req_id: r.generated_tokens
                                      for r in fin},
                           **_counters(eng, before)}
    assert rep.grow_failures > 0 and rep.grow_preemptions > 0
    print(f"  [real] tight budget: {rep.grow_failures:.0f} grow failures, "
          f"{rep.grow_preemptions:.0f} preemptions, all requests finished")
    return out


# ------------------------------------------------------------------ kernel
def kernel_inputs(*, b: int = 4, h: int = 8, kh: int = 2, bs: int = 16,
                  mb: int = 8, dh: int = 64, device: DeviceLike = "cuda"):
    """The reference bench's case in the port's pool layout ``(N, bs, KH,
    dh)``: f32 normals from seed 0, tables shuffled (seed 0) with block 0
    aliased into every row, lengths ``mb * bs - (11 i) % (mb * bs - 1)``.
    Returns (q, k_pool, v_pool, tables, lengths)."""
    dev = resolve_device(device)
    n_blocks = 2 * b * mb
    rng = np.random.default_rng(0)
    q, k_pool, v_pool = (torch.as_tensor(
        rng.standard_normal(shape, dtype=np.float32), device=dev)
        for shape in ((b, h, dh), (n_blocks, bs, kh, dh),
                      (n_blocks, bs, kh, dh)))
    rng = np.random.default_rng(0)
    tables = np.stack([rng.permutation(n_blocks)[:mb] for _ in range(b)])
    tables[:, 0] = 0                              # aliased shared block
    lengths = [mb * bs - (11 * i) % (mb * bs - 1) for i in range(b)]
    return (q, k_pool, v_pool,
            torch.as_tensor(tables, dtype=torch.int32, device=dev),
            torch.as_tensor(lengths, dtype=torch.int32, device=dev))


def run_kernel(*, b: int = 4, h: int = 8, kh: int = 2, bs: int = 16,
               mb: int = 8, dh: int = 64, iters: int = 20,
               device: DeviceLike = "cuda") -> dict:
    """The port's paged kernel vs its plain version on shuffled + aliased
    tables; on the card also its back-to-back time (CUDA events). Reports
    the wrappers' launches it made."""
    dev = resolve_device(device)
    args = kernel_inputs(b=b, h=h, kh=kh, bs=bs, mb=mb, dh=dh, device=dev)
    before = launches()
    out = paged_decode_attention(*args)
    ref = paged_decode_attention_plain(*args)
    err = float((out - ref).abs().max())
    assert err < 2e-5, f"paged kernel off its plain version by {err}"
    us = None
    if dev.type == "cuda":
        us = cuda_ms(lambda: paged_decode_attention(*args), iters) * 1e3
    print(f"  [kernel] paged decode parity max|err|={err:.2e}"
          + (f", {us:.1f} us/call (back-to-back)" if us is not None
             else " (plain version on the CPU, not timed)"))
    return {"max_abs_err": err, "us_per_call": us,
            "launches": launches_since(before),
            "shape": dict(b=b, h=h, kh=kh, block_size=bs, max_blocks=mb,
                          dh=dh)}


def run(*, smoke: bool = False, full: bool = False,
        device: DeviceLike = "cuda", mode: str = "all") -> dict:
    """The sections ``mode`` names, at the reference's default or
    ``--smoke`` sizes."""
    results = {}
    if mode in ("sim", "all"):
        print("simulator (A100-scale constants):")
        kw = dict(n=8, out_len=32, kv_blocks=12, tight_blocks=5) \
            if smoke else {}
        results["sim"] = run_sim(**kw)
    if mode in ("real", "all"):
        print(f"real engine ({'published' if full else 'smoke'} width, "
              f"f32, wall clock):")
        kw = dict(shared_words=16, n_warm=2, prompt_len=32, n_tight=4) \
            if smoke else {}
        results["real"] = run_real(full=full, device=device, **kw)
    if mode in ("kernel", "all"):
        print("paged decode kernel:")
        kw = dict(b=2, mb=4, iters=5) if smoke else {}
        results["kernel"] = run_kernel(device=device, **kw)
    if "sim" in results:
        s = results["sim"]
        emit("paged_decode_sim", s["incremental"]["avg_ttft_s"] * 1e6,
             f"incremental reservation holds "
             f"{s['concurrency_ratio']:.1f}x more concurrent requests at "
             f"{s['kv_blocks']} KV blocks; "
             f"{s['tight_budget']['grow_preemptions']:.0f} grow-preemptions "
             f"recovered on the tight budget")
    return results


def section(results: dict) -> dict:
    """The reference's ``paged_decode`` section keys, then the real and
    kernel sections whole."""
    out = dict(results)
    if "sim" in results:
        s = results["sim"]
        out.update({
            "concurrency_ratio": s["concurrency_ratio"],
            "peak_concurrency_full": s["full"]["peak_concurrency"],
            "peak_concurrency_incremental":
                s["incremental"]["peak_concurrency"],
            "tight_budget_grow_failures":
                s["tight_budget"]["grow_failures"],
            "tight_budget_grow_preemptions":
                s["tight_budget"]["grow_preemptions"],
        })
    real = results.get("real", {})
    out.update(real_prefix_tokens_copied=real.get("prefix_tokens_copied"),
               real_identical_outputs=real.get("identical_outputs"),
               width=real.get("width"))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="benchmarks.torch_paged_decode")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI config: prove the concurrency bar, "
                         "recovery, zero-copy hits, and kernel parity")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (on the card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="merge the section into this file instead of "
                    "BENCH_torch.json at the repo root")
    ap.add_argument("--mode", choices=("sim", "real", "kernel", "all"),
                    default="all")
    args = ap.parse_args(argv)
    resolve_device(args.device)           # no card: fail before any work
    t0 = time.perf_counter()
    results = run(smoke=args.smoke, full=args.full, device=args.device,
                  mode=args.mode)
    payload = {**section(results), **section_meta(args.device, None),
               "wall_s": time.perf_counter() - t0}
    record_torch_bench("paged_decode", payload,
                       args.json or BENCH_TORCH_JSON)
    return payload


if __name__ == "__main__":
    main()
