#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (sm_90a:
H100). Imports nothing of JAX or of the JAX package. Phases, in order; any
failed check raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``), then the build
   of every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once).
2. Kernels at the main paths' shapes, each held against its plain PyTorch
   version on the card: attention f32 with TF32 off at 2e-5 and bf16 at
   2e-2 (paged decode also at the served lengths and at lengths around its
   split boundaries, length 0 against the uniform average, aliased block
   tables over three splits bitwise; the prefill kernel's bare wgmma tile
   against plain matrix products; ring decode at positions around its
   split boundaries and the ring wrap, with a window shorter than the lane,
   and rows on one slot and pos bitwise), chunked linear attention at 5e-4
   (its final state included, also against a token-by-token recurrence and
   with every step's log-decay at the contract's edge; its bare 3xTF32
   tile against plain matrix products at 1e-5), in ``ssd`` mode at
   Hymba's heads and in ``rwkv`` mode at RWKV-6 7B's served prefill shape
   (8 x 128 tokens) and at 4 x 256. Paged decode also at the MoE and VLM
   paths' served shapes (OLMoE's 16 KV heads of group 1, Qwen2-VL's 8 of
   group 8) and prefill at H = KH = 16. Whisper's instances: the prefill
   kernel without the causal mask at its encoder's shape (B 4, H = KH =
   6, S 1,500, dh 64: a partial last query tile) and its cross-attention's
   (64 queries over 1,500 keys), and ring decode over 1,500-row cross
   lanes with every row visible (also against unmasked attention).
   Moonlight-16B-A3B's MLA kernels in bf16 at 2e-2: the latent decode
   kernel (16 heads over 576-wide latent rows, V their first 512, scale
   1/sqrt(192), 2,048-position tables) at 64 served lengths, one row, the
   split boundaries and the full table, and the prefill kernel's (192,
   128) instance on first chunks of 1 to 512 tokens and on continuation
   chunks over longer lanes; for each, planted faults (a length one short
   and a wrong scale; a wrong scale and the causal mask one position late)
   must fall outside the tolerance. Kimi K2's: the latent decode kernel's
   64-head instance at YaRN's scale (0.130861), 1, 16 and 64 rows at
   positions 159 and 2,047 (a planted fault, the scale without mscale^2,
   must fall outside), timed at 1, 16 and 64 rows of 160 (row 5a), and
   the prefill kernel's (192, 128) instance at H = KH = 64 with that
   scale (row 2e's H 64 entry). Each MoE slot's place within its expert
   (``slot_positions``) bitwise against the one-hot ``cumsum`` at a
   512-token first chunk of OLMoE (top-8 of 64), Moonlight (top-6 of 64)
   and Kimi K2 (top-8 of 384) and a 64-row decode step (64 groups of
   one token), each timed device-only beside the plain expression and its
   byte bound. Times the kernel, the plain version and, where one exists, one PyTorch
   library call computing the same function (``library_ms``, timed here
   only) as back-to-back calls with CUDA events (``ms``, ``plain_ms``,
   ``library_ms``: L2-warm, and at small times partly the host's), and
   the kernel and library call on the device alone, their launches
   captured in a CUDA graph: with inputs in L2 (``device_ms``,
   ``library_device_ms``) and rotating over copies that read three times
   the 50 MB L2 between two uses (``cold_ms``, ``library_cold_ms``). Also
   computes the least time the card could take (``bound_ms``).
3. Parity at full width, cut to 4 layers, f32 with TF32 off:
   ``llama3_2_3b``: greedy tokens of a chunked, prefix-cached run equal an
   unchunked, uncached run; ``hymba_1_5b``: greedy decoding across a
   wrapped ring lane equals the CPU run's tokens; ``rwkv6_7b``: a 32-token
   prefill and 16 greedy decode steps equal the CPU run's tokens. For all
   three, the model's logits on the card agree with the same model run on
   the CPU through the plain versions. ``olmoe_1b_7b`` at the published
   capacity factor 1.25: a 4 x 64-token prefill (some token-slots must be
   dropped, as many on the card as on the CPU) and 16 greedy decode steps,
   logits and tokens against the CPU's. Then ``nemotron_4_15b``,
   ``moonshot_v1_16b_a3b`` (MoE, shared expert) and ``qwen2_vl_72b``
   (M-RoPE) at their f32 smoke widths on the paged kernels: a burst's
   greedy tokens equal the CPU's.
4. Serving full ``llama3_2_3b`` (28 layers, bf16, paged KV), full
   ``hymba_1_5b`` (32 layers, bf16, contiguous ring lanes), full
   ``rwkv6_7b`` (32 layers, bf16, per-slot recurrent state, no K/V) and
   full ``olmoe_1b_7b`` (16 layers, 64 experts, bf16, paged KV; MoE first
   chunks padded with replicas of lane 0), each behind a
   ``pars_bert_base``-width ranking predictor, seeded on the card: a burst
   of 16 requests under PARS and under FCFS; then ``qwen2_vl_72b`` at full
   width cut to 16 of its 80 layers, under PARS. Every kernel's launch
   count is set to 0 just before each run and read just after: each kernel
   of the path must have launched, and no kernel of another path. Then the
   command-line launcher (``repro_torch.launch.serve --full``) serves a
   short burst of each architecture: under FCFS, but under PARS for
   rwkv6_7b, training its full-width predictor first; for qwen2_vl_72b it
   must refuse, saying that the published model does not fit. Then full
   ``moonlight_16b_a3b`` (27 layers of MLA over a latent pool, 26 of them
   sigmoid-routed experts with shared ones; 15.96 B in bf16) in the
   benchmark cell's engine under PARS, decode graphs captured: a 16-request
   burst in two waves (the second hits the first's cached prefixes) with
   every launch count zeroed after the captures, the latent
   decode kernel exactly 27 a decode step, all of them replays, the
   prefill kernel exactly 27 a prefill or extend dispatch, the MoE
   slot-place kernel exactly 26 a dispatch of either kind, no other
   kernel; then each batch bucket's replayed decode step and the eager
   step timed (rows at position 160), with the expert rows and routed
   slots a step adds, and the replay of a 64-token first chunk. Then
   ``kimi_k2_instruct``, one H100's share of Kimi K2 (11 layers: 64 heads
   of MLA with a query low-rank path and YaRN, 48 of 384 experts held;
   23.41 B in bf16, weights drawn by the benchmark's ``mla_ep``), the
   same way: the latent decode kernel's 64-head instance exactly 11 a
   decode step, every decode step and first chunk replayed, and
   ``held_slots / routed_slots`` and ``expert_rows`` printed. Then full
   ``olmoe_1b_7b`` in the benchmark cell's engine (64 slots, chunks of
   512), its steps timed the same way: decode buckets 1 to 64 and first
   chunks of 1 x 512, 8 x 64 and 1 x 8 tokens. Then
   ``whisper_tiny`` at its published widths through ``build(cfg)`` (the
   reference's inference path; neither engine serves the family): f32,
   TF32 off, ``prefill`` and 8 greedy ``decode_step``s on the card against
   the CPU (logits at 1e-3, tokens equal) and against the full forward;
   then bf16, 4 requests of 64-token prompts and 32 greedy tokens, every
   launch count zeroed just before: exactly 12 prefill kernels (4
   encoder, 4 self, 4 cross) and 8 ring decode kernels a decode step, no
   other kernel; ms a token.
5. The device time of each kernel that one call of each kernel
   launches, at the record's shapes, after every unprofiled run (bursts
   that followed a profiler session in the same process were seen to run
   slower), and each kernel's launches in the PARS bursts.
6. Training the ranking predictor on the card: the mini predictor to the
   reference's bar (pairwise, held-out Kendall tau_b >= 0.45), one epoch
   each of the pointwise and listwise baselines, and the serve launcher's
   full-width ``pars_bert_base`` predictor (loss, ms per step and held-out
   tau_b per epoch). A non-finite loss fails. Then, in each of two child
   processes with different hash salts, three of that predictor's steps
   run once with PyTorch's default kernels and twice under deterministic
   algorithms: the deterministic runs must end with bitwise equal
   parameters, in one process and across the two.
7. Trained PARS on the served path: a 32-request burst on full
   ``llama3_2_3b`` (phase 4's paged engine) under FCFS, PARS with the
   phase-6 predictor and oracle SJF; every request finishes, the scorer
   never fails, the predictor's tau_b on the burst is above 0. Latencies
   are logged, not asserted.
8. Training the LM: full-width ``llama3_2_3b`` cut to 4 layers, f32, TF32
   off: the training forward (chunked attention) within 1e-3 of the kernel
   path's logits, one train step's loss and grad norm on the card within
   1e-3 relative of the CPU's; then the full model in bf16 with remat, ten
   steps on one batch of 4 x 64 (the loss falls, grad norms are finite;
   ms per step, tokens/s, peak memory, share of the bf16 peak), and the
   train launcher (``repro_torch.launch.train --full``) for two steps.
   Then the hybrid, SSM and encoder-decoder families: at full width in
   f32 (``hymba_1_5b`` and ``rwkv6_7b`` cut to 4 layers, ``whisper_tiny``
   whole), the training forward within 1e-3 of the kernel route, one
   step's loss and grad norm within 1e-3 relative of the same step on the
   CPU in f64; then bf16 with remat, ten steps on one batch of 4 x 64 of
   full ``hymba_1_5b``, ``rwkv6_7b`` cut to 12 of its 32 layers and whole
   ``whisper_tiny`` (the loss falls; ms a step, tokens/s, peak memory,
   device time by kernel); on ``hymba_1_5b`` the forward peaks of one
   gradient pass under remat none, dots and full read none >= dots >=
   full.
9. The paper's benchmarks on the card, through the port: Tables I–IV, the
   cross-model study and the PARS+ ablation (``benchmarks.torch_run``,
   FAST scale, the mini predictor, every predictor trained on the card),
   then the admission twin (``benchmarks.torch_prefill_admission
   --full``: full ``llama3_2_3b``, bf16, bursts of 8 prompts, 4 reps,
   sequential against bucketed prefill). Bars, the reference's own: Table
   II's alpaca/gpt4 pairwise tau_b >= 0.45; in each cross-model cell
   oracle <= native PARS x 1.001 and native PARS < FCFS in average
   per-token latency. Every admission request finishes, bucketed makes
   fewer dispatches than sequential, the prefill kernel launches in every
   layer of every prefill dispatch and paged decode in the decode steps,
   and no other kernel. The simulator serving twins (``router``,
   ``iterative_rank``, ``fault_tolerance``, ``workload_harness``) run at
   the reference's ``--smoke`` sizes beside the tables, on no device.
   Then the engine halves of the serving twins at published
   ``llama3_2_3b`` width in f32 with TF32 off (``paged_decode``,
   ``chunked_prefill`` and ``prefix_caching --full``, the reference's
   default sizes), every launch count set to 0 just before each twin and
   read just after, each twin reporting its runs' own counts: the prefill
   kernel in every layer of every prefill and extend dispatch, paged
   decode in a multiple of the layers in every paged run, ring decode in
   a multiple of the layers in ``paged_decode``'s contiguous run and
   nowhere else, the chunked kernel never. Bars, the reference's own:
   greedy tokens identical across each twin's two routes (paged against
   ring lanes, chunked against one-shot prefill, a cache hit against a
   full prefill), no KV token copied on the paged hit path, grow
   preemptions recovering on a 6-block budget, incremental reservation
   admitting >= 1.5x. Then the kernel microbench twin
   (``benchmarks.torch_kernel_bench``: prefill at S 512, ring decode over
   8,192-row lanes, ``rwkv`` mode over 1,024 tokens, each against its
   plain version, timed as in phase 2 beside SDPA and its bound) and
   ``examples/torch_serve_e2e.py --full`` (8 requests under FCFS, PARS and
   oracle). The sections go to ``chiprun_out/BENCH_torch.json`` and must
   pass ``benchmarks.torch_check_bench --card``.
10. The roofline on the card: the dry-run's analysis
    (``repro_torch.launch.dryrun``: each step traced once on ``meta``
    tensors over a placeholder process group, on the (1, 1) mesh) of the
    four bf16 train steps phase 8 timed, with phase 8's configs. Each
    roofline time (the larger of its compute and memory terms over the
    H100's datasheet rates) must be at or below its step's measured
    device-busy time; the terms, the bottleneck, the measured ms and
    device-busy ms and their ratios to the roofline, and the predicted
    peak memory against ``torch.cuda.max_memory_allocated`` are printed.
    No step runs on the card. Then one production combination
    (``llama3_2_3b`` ``train_4k`` on the 256-rank mesh) is traced and its
    row printed with its ``trace_s``.

The last lines are JSON objects of Whisper's numbers, of training
numbers, of the benchmarks'
numbers (tau per table cell, speedups, dispatches, wall per bench, the
serving twins' latencies and launches), of per-kernel numbers (the
microbench's shapes under ``bench_*`` keys) and then ``{"ok": true,
"device": {...}}``. It exits non-zero, printing no result, where no CUDA
card is visible or the repository's files cannot be imported.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmarks.torch_timing import (BF16_FLOPS_S, bound, cuda_ms,
                                     device_ms, device_times)

ROOT = Path(__file__).resolve().parent
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def free_memory() -> None:
    """Return the memory of the phase before to the card: an engine and
    its core refer to each other, so only the cycle collector frees the
    weights an engine holds."""
    gc.collect()
    torch.cuda.empty_cache()


def kernel_ms(fn, calls: int = 50) -> dict:
    """Device milliseconds per call of each CUDA kernel that ``fn``
    launches, from ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", name.removeprefix("void "))[0]
            name = name.split("::")[-1].strip()
            times[name] = times.get(name, 0.0) + t / 1e3 / calls
    return times


def _device_event(e) -> bool:
    """A kernel, copy or fill on the device (not a host event, and not the
    device-side span of a host range)."""
    from torch.autograd import DeviceType

    return e.device_type() != DeviceType.CPU and not e.is_user_annotation()


def device_rows(prof) -> list:
    """``[(device ms, calls, name)]`` of a ``torch.profiler`` session, one
    row per kernel or copy that ran on the device, summed from the
    session's raw events (``key_averages()``, which builds the profiler's
    event tree, took a minute and more at a burst's ~10^5 kernels)."""
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if _device_event(e):
            t, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + e.duration_ns(), n + 1)
    return [(t / 1e6, n, name) for name, (t, n) in by_name.items()]


def check_close(name: str, out, ref, tol: float) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"{name}: {m}")
    log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _paged_sdpa_args(q, kp, vp, tb, ln, g):
    """The SDPA yardstick's inputs for paged decode, made outside the timed
    call: each table gathered into a lane, heads expanded, the length mask
    as bool."""
    b, mb = tb.shape
    _, bs, kh, dh = kp.shape
    lanes = [p[tb.long()].reshape(b, mb * bs, kh, dh).permute(0, 2, 1, 3)
             .repeat_interleave(g, 1).contiguous() for p in (kp, vp)]
    mask = torch.arange(mb * bs, device=q.device)[None] < ln[:, None].long()
    return q[:, :, None, :].contiguous(), *lanes, mask[:, None, None, :]


def _paged_times(label, q, kp, vp, tb, ln, g) -> dict:
    """Device-only times (warm and L2-cold) of paged decode and of its SDPA
    yardstick at one set of lengths, beside the bound for those lengths."""
    from repro_torch.kernels.flash_decode.ops import paged_decode_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, dh = q.shape
    kh = kp.shape[2]
    rows = int(ln.sum())
    bytes_moved = (2 * rows * kh * dh * 2          # K and V rows read, bf16
                   + 2 * b * h * dh * 2            # q in, out
                   + tb.numel() * 4 + b * 4)       # tables, lengths
    bound_ms, bound_by = bound(bytes_moved, 4 * rows * h * dh)

    def kernel(i):
        a = (q, kp, vp) if i == 0 else (q.clone(), kp.clone(), vp.clone())
        return lambda: paged_decode_attention(*a, tb, ln)

    lib0 = _paged_sdpa_args(q, kp, vp, tb, ln, g)

    def library(i):
        a = lib0 if i == 0 else tuple(x.clone() for x in lib0)
        return lambda: sdpa(a[0], a[1], a[2], attn_mask=a[3])

    t = {"bound_ms": bound_ms, "bound_by": bound_by}
    t["device_ms"], t["cold_ms"] = device_times(kernel, bytes_moved)
    t["library_device_ms"], t["library_cold_ms"] = device_times(
        library, sum(x.numel() * x.element_size() for x in lib0))
    log(f"  decode bf16 {label} ({rows} rows), device-only: kernel "
        f"{t['device_ms']:.5f} ms warm, {t['cold_ms']:.5f} ms L2-cold; SDPA "
        f"{t['library_device_ms']:.5f} / {t['library_cold_ms']:.5f} ms; "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return t


def phase_decode_kernel(dev):
    from repro_torch.kernels.flash_decode.ops import (
        paged_decode_attention, paged_decode_attention_plain, split_geometry)

    b, kh, g, dh, bs, mb = 8, 8, 3, 128, 16, 32
    h, n = kh * g, b * mb + 1
    entries, splits = split_geometry(bs, mb)
    split = entries * bs
    rng = np.random.default_rng(SEED)
    tables = np.stack([rng.permutation(n)[:mb] for _ in range(b)])
    lengths = np.asarray([mb * bs, 1, 17, 100, 255, 256, 400, 511], np.int32)
    q32 = torch.randn(b, h, dh, device=dev)
    kp32 = torch.randn(n, bs, kh, dh, device=dev)
    vp32 = torch.randn(n, bs, kh, dh, device=dev)
    tb = torch.as_tensor(tables, dtype=torch.int32, device=dev)
    ln = torch.as_tensor(lengths, device=dev)
    # the served path's lengths: 128-token prompts plus up to 64 generated
    served = torch.as_tensor(128 + rng.integers(1, 65, b), dtype=torch.int32,
                             device=dev)
    # empty, one row, a split boundary -1/0/+1, three splits, the full table
    edges = torch.tensor([0, 1, split - 1, split, split + 1, 3 * split,
                          mb * bs - 1, mb * bs], dtype=torch.int32,
                         device=dev)
    log(f"paged decode: B={b} KH={kh} G={g} dh={dh} bs={bs} "
        f"max_blocks={mb} ({splits} splits of {split} rows) "
        f"lengths={lengths.tolist()}, served lengths {served.tolist()}, "
        f"edge lengths {edges.tolist()}")
    errs = {}
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        t = getattr(torch, dt)
        pools = (q32.to(t), kp32.to(t), vp32.to(t), tb)
        errs[dt] = max(check_close(
            f"decode {label} {dt}", paged_decode_attention(*pools, lens),
            paged_decode_attention_plain(*pools, lens), tol)
            for label, lens in (("", ln), ("served lengths", served),
                                ("edge lengths", edges)))
    # lengths == 0: the uniform average over the table's rows
    out = paged_decode_attention(q32, kp32, vp32, tb, edges)
    mean = vp32[tb[0].long()].reshape(mb * bs, kh, 1, dh).mean(0)
    check_close("decode length 0 vs uniform average (f32)", out[0],
                mean.expand(kh, g, dh).reshape(h, dh), 2e-5)
    # aliased tables spanning three splits: same query, same length
    alias = tb.clone()
    alias[1, :3 * entries] = alias[0, :3 * entries]
    q2 = q32.clone()
    q2[1] = q2[0]
    l2 = torch.full((b,), 3 * split - 5, dtype=torch.int32, device=dev)
    for t in (torch.float32, torch.bfloat16):
        out = paged_decode_attention(q2.to(t), kp32.to(t), vp32.to(t), alias,
                                     l2)
        torch.cuda.synchronize()
        if not torch.equal(out[0], out[1]):
            raise AssertionError(f"decode: aliased tables over 3 splits are "
                                 f"not bitwise equal ({t})")
    log(f"  decode aliased tables over 3 splits ({3 * split - 5} rows): "
        f"bitwise equal, f32 and bf16")

    # timing in the main path's dtype
    bf = torch.bfloat16
    q, kp, vp = q32.to(bf), kp32.to(bf), vp32.to(bf)
    ms = cuda_ms(lambda: paged_decode_attention(q, kp, vp, tb, ln), 200)
    plain_ms = cuda_ms(
        lambda: paged_decode_attention_plain(q, kp, vp, tb, ln), 20)
    lib = _paged_sdpa_args(q, kp, vp, tb, ln, g)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(lib[0], lib[1], lib[2],
                                      attn_mask=lib[3]), 200)
    log(f"  decode bf16, back-to-back calls (L2-warm): {ms:.4f} ms kernel, "
        f"{plain_ms:.4f} ms plain, {library_ms:.4f} ms SDPA")
    entry = {"name": "paged_decode_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
             "replaces": "src/repro/kernels/flash_decode/kernel.py:193",
             "max_abs_err": errs["bfloat16"], "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms,
             **_paged_times("record lengths", q, kp, vp, tb, ln, g),
             "call": lambda: paged_decode_attention(q, kp, vp, tb, ln)}
    at_served = _paged_times("served lengths", q, kp, vp, tb, served, g)
    entry.update({f"served_{k}": v for k, v in at_served.items()
                  if k != "bound_by"})
    return entry


def phase_prefill_kernel(dev):
    from repro_torch.kernels.flash_prefill.ops import (
        flash_attention, flash_attention_plain, wgmma_tile_check,
        wgmma_tile_check_plain)

    # the bf16 kernel's shared-memory tiles and wgmma descriptors, bare:
    # S = Q K^T and O = bf16(S) V on one tile against plain products
    for tdh in (32, 64, 128):
        tile = [torch.randn(64, tdh, device=dev).to(torch.bfloat16)
                for _ in range(3)]
        s_t, o_t = wgmma_tile_check(*tile)
        torch.cuda.synchronize()
        s_ref, o_ref = wgmma_tile_check_plain(*tile)
        check_close(f"wgmma tile dh={tdh}: S = Q K^T", s_t, s_ref, 1e-3)
        check_close(f"wgmma tile dh={tdh}: O = bf16(S) V", o_t, o_ref, 1e-2)

    b, h, kh, sq, dh = 8, 24, 8, 128, 128
    log(f"prefill: B={b} H={h} KH={kh} Sq={sq} dh={dh}")
    q32 = torch.randn(b, h, sq, dh, device=dev)
    k32 = torch.randn(b, kh, sq, dh, device=dev)
    v32 = torch.randn(b, kh, sq, dh, device=dev)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    full = torch.full((b,), sq, dtype=torch.int32, device=dev)
    # continuation chunks: 64 queries at per-row offsets over 512-row lanes
    c, w = 64, 512
    starts = torch.tensor([0, 16, 64, 128, 192, 256, 384, 448],
                          dtype=torch.int32, device=dev)
    qc32 = torch.randn(b, h, c, dh, device=dev)
    kc32 = torch.randn(b, kh, w, dh, device=dev)
    vc32 = torch.randn(b, kh, w, dh, device=dev)
    errs = {}
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        t = getattr(torch, dt)
        args = (q32.to(t), k32.to(t), v32.to(t), zero, full)
        out = flash_attention(*args)
        torch.cuda.synchronize()
        errs[dt] = check_close(f"prefill q_start=0 {dt}", out,
                               flash_attention_plain(*args), tol)
        args = (qc32.to(t), kc32.to(t), vc32.to(t), starts, starts + c)
        out = flash_attention(*args)
        torch.cuda.synchronize()
        errs[dt] = max(errs[dt], check_close(
            f"prefill offsets {dt}", out, flash_attention_plain(*args), tol))

    # Hymba's prefill shape (G=5, dh=64) under a window shorter than the
    # prompt, so that the window mask cuts keys
    hq = torch.randn(b, 25, sq, 64, device=dev)
    hk = torch.randn(b, 5, sq, 64, device=dev)
    hv = torch.randn(b, 5, sq, 64, device=dev)
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        t = getattr(torch, dt)
        args = (hq.to(t), hk.to(t), hv.to(t), zero, full)
        out = flash_attention(*args, window=48)
        torch.cuda.synchronize()
        errs[dt] = max(errs[dt], check_close(
            f"prefill H=25 KH=5 dh=64 window 48 {dt}", out,
            flash_attention_plain(*args, window=48), tol))

    bf = torch.bfloat16
    q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
    ms = cuda_ms(lambda: flash_attention(q, k, v, zero, full), 100)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, zero, full), 20)
    ke = k.repeat_interleave(h // kh, 1).contiguous()
    ve = v.repeat_interleave(h // kh, 1).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, ke, ve, is_causal=True), 100)
    pairs = b * h * sq * (sq + 1) // 2             # unmasked (query, key)
    flops = 4 * dh * pairs
    bytes_moved = 2 * (2 * b * h * sq * dh + 2 * b * kh * sq * dh) + 8 * b
    bound_ms, bound_by = bound(bytes_moved, flops)
    log(f"  prefill bf16, back-to-back calls (L2-warm): {ms:.4f} ms kernel, "
        f"{plain_ms:.4f} ms plain, {library_ms:.4f} ms SDPA, bound "
        f"{bound_ms:.5f} ms ({bound_by})")

    def kernel(i):
        a = (q, k, v) if i == 0 else (q.clone(), k.clone(), v.clone())
        return lambda: flash_attention(*a, zero, full)

    def library(i):
        a = (q, ke, ve) if i == 0 else (q.clone(), ke.clone(), ve.clone())
        return lambda: sdpa(*a, is_causal=True)

    t = {}
    t["device_ms"], t["cold_ms"] = device_times(kernel, bytes_moved)
    t["library_device_ms"], t["library_cold_ms"] = device_times(
        library, 2 * 4 * b * h * sq * dh)          # q, k, v, out (bf16)
    log(f"  prefill bf16, device-only: kernel {t['device_ms']:.5f} ms warm, "
        f"{t['cold_ms']:.5f} ms L2-cold; SDPA {t['library_device_ms']:.5f} / "
        f"{t['library_cold_ms']:.5f} ms")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
            "replaces": "src/repro/kernels/flash_prefill/kernel.py:105",
            "max_abs_err": errs["bfloat16"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **t,
            "call": lambda: flash_attention(q, k, v, zero, full)}


def phase_moe_vlm_instances(dev) -> dict:
    """Paged decode at the MoE and VLM paths' served shapes, OLMoE's (KH 16,
    one query head per KV head) and Qwen2-VL's (KH 8, group 8), and
    prefill at H = KH = 16: each against its plain version (f32 at 2e-5,
    bf16 at 2e-2), timed back-to-back and device-only (warm and L2-cold),
    beside SDPA timed both ways and the bound. Returns keys for the two
    kernels' entries."""
    from repro_torch.kernels.flash_decode.ops import (
        paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.flash_prefill.ops import (
        flash_attention, flash_attention_plain)

    b, dh, bs, mb = 8, 128, 16, 32
    rng = np.random.default_rng(SEED + 1)
    served = torch.as_tensor(128 + rng.integers(1, 65, b), dtype=torch.int32,
                             device=dev)
    bf = torch.bfloat16
    out = {"paged_decode_attention": {}, "flash_attention": {}}
    for label, kh, g in (("olmoe", 16, 1), ("qwen2_vl", 8, 8)):
        h, n = kh * g, b * mb + 1
        log(f"paged decode ({label}): B={b} KH={kh} G={g} dh={dh} bs={bs} "
            f"max_blocks={mb} lengths {served.tolist()}")
        tb = torch.as_tensor(np.stack([rng.permutation(n)[:mb]
                                       for _ in range(b)]),
                             dtype=torch.int32, device=dev)
        q32 = torch.randn(b, h, dh, device=dev)
        kp32 = torch.randn(n, bs, kh, dh, device=dev)
        vp32 = torch.randn(n, bs, kh, dh, device=dev)
        for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            t = getattr(torch, dt)
            args = (q32.to(t), kp32.to(t), vp32.to(t), tb, served)
            out_k = paged_decode_attention(*args)
            torch.cuda.synchronize()
            err = check_close(f"decode {label} {dt}", out_k,
                              paged_decode_attention_plain(*args), tol)
        q, kp, vp = q32.to(bf), kp32.to(bf), vp32.to(bf)
        lib = _paged_sdpa_args(q, kp, vp, tb, served, g)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        t = {"max_abs_err": err,
             "ms": cuda_ms(lambda: paged_decode_attention(q, kp, vp, tb,
                                                          served), 200),
             "plain_ms": cuda_ms(lambda: paged_decode_attention_plain(
                 q, kp, vp, tb, served), 20),
             "library_ms": cuda_ms(lambda: sdpa(lib[0], lib[1], lib[2],
                                                attn_mask=lib[3]), 200),
             **_paged_times(f"{label} served lengths", q, kp, vp, tb, served,
                            g)}
        log(f"  decode {label} bf16, back-to-back: {t['ms']:.4f} ms kernel, "
            f"{t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms SDPA")
        out["paged_decode_attention"].update(
            {f"{label}_{k}": v for k, v in t.items()})

    h = kh = 16
    sq = 128
    log(f"prefill (olmoe): B={b} H={h} KH={kh} Sq=Skv={sq} dh={dh}")
    q32 = torch.randn(b, h, sq, dh, device=dev)
    k32 = torch.randn(b, kh, sq, dh, device=dev)
    v32 = torch.randn(b, kh, sq, dh, device=dev)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    full = torch.full((b,), sq, dtype=torch.int32, device=dev)
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        t = getattr(torch, dt)
        args = (q32.to(t), k32.to(t), v32.to(t), zero, full)
        out_k = flash_attention(*args)
        torch.cuda.synchronize()
        err = check_close(f"prefill H=KH={h} {dt}", out_k,
                          flash_attention_plain(*args), tol)
    q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bytes_moved = 2 * (2 * b * h * sq * dh + 2 * b * kh * sq * dh) + 8 * b
    bound_ms, bound_by = bound(bytes_moved,
                               4 * dh * b * h * sq * (sq + 1) // 2)
    t = {"max_abs_err": err,
         "ms": cuda_ms(lambda: flash_attention(q, k, v, zero, full), 100),
         "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, zero,
                                                           full), 20),
         "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True), 100),
         "bound_ms": bound_ms, "bound_by": bound_by}

    def kernel(i):
        a = (q, k, v) if i == 0 else (q.clone(), k.clone(), v.clone())
        return lambda: flash_attention(*a, zero, full)

    def library(i):
        a = (q, k, v) if i == 0 else (q.clone(), k.clone(), v.clone())
        return lambda: sdpa(*a, is_causal=True)

    t["device_ms"], t["cold_ms"] = device_times(kernel, bytes_moved)
    t["library_device_ms"], t["library_cold_ms"] = device_times(
        library, bytes_moved)
    log(f"  prefill H=KH={h} bf16: back-to-back {t['ms']:.4f} ms kernel, "
        f"{t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms SDPA; "
        f"device-only kernel {t['device_ms']:.5f} ms warm, "
        f"{t['cold_ms']:.5f} ms L2-cold; SDPA {t['library_device_ms']:.5f} / "
        f"{t['library_cold_ms']:.5f} ms; bound {bound_ms:.5f} ms "
        f"({bound_by})")
    out["flash_attention"].update({f"olmoe_{k}": v for k, v in t.items()})
    return out


def phase_whisper_instances(dev) -> dict:
    """Whisper's three kernel instances at ``whisper_tiny``'s shapes, each
    held against its plain version (f32 at 2e-5, bf16 at 2e-2) and timed as
    the record's rows are (back-to-back; device-only L2-warm and L2-cold),
    beside SDPA called the same way (``is_causal=False``) and the bound:
    the prefill kernel without the causal mask over the encoder's 1,500
    frames (B 4, H = KH = 6, dh 64; 1,500 is not a multiple of the 64-row
    query tile, so the last tile is partial) and for the decoder's
    cross-attention (64 prompt rows over the 1,500 encoder rows), and ring
    decode over 1,500-row cross lanes at ``pos = F - 1``, every row
    visible (also held against unmasked attention over the lane). Returns
    keys for the two kernels' entries."""
    from repro_torch.kernels.flash_decode.ops import (
        ring_decode_attention, ring_decode_attention_plain)
    from repro_torch.kernels.flash_prefill.ops import (
        flash_attention, flash_attention_plain)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, dh, f = 4, 6, 64, 1500
    bf = torch.bfloat16
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    full = torch.full((b,), f, dtype=torch.int32, device=dev)
    out = {"flash_attention": {}, "ring_decode_attention": {}}
    for label, sq in (("whisper_encoder", f), ("whisper_cross", 64)):
        log(f"prefill causal=False ({label}): B={b} H=KH={h} Sq={sq} "
            f"Skv={f} dh={dh}")
        q32 = torch.randn(b, h, sq, dh, device=dev)
        k32 = torch.randn(b, h, f, dh, device=dev)
        v32 = torch.randn(b, h, f, dh, device=dev)
        for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            t = getattr(torch, dt)
            args = (q32.to(t), k32.to(t), v32.to(t), zero, full)
            out_k = flash_attention(*args, causal=False)
            torch.cuda.synchronize()
            err = check_close(f"prefill {label} causal=False {dt}", out_k,
                              flash_attention_plain(*args, causal=False), tol)
        q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
        bytes_moved = 2 * (2 * b * h * sq * dh + 2 * b * h * f * dh) + 8 * b
        bound_ms, bound_by = bound(bytes_moved, 4 * dh * b * h * sq * f)
        t = {"max_abs_err": err,
             "ms": cuda_ms(lambda: flash_attention(q, k, v, zero, full,
                                                   causal=False), 100),
             "plain_ms": cuda_ms(lambda: flash_attention_plain(
                 q, k, v, zero, full, causal=False), 10),
             "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=False),
                                   100),
             "bound_ms": bound_ms, "bound_by": bound_by}

        def kernel(i, q=q, k=k, v=v):
            a = (q, k, v) if i == 0 else (q.clone(), k.clone(), v.clone())
            return lambda: flash_attention(*a, zero, full, causal=False)

        def library(i, q=q, k=k, v=v):
            a = (q, k, v) if i == 0 else (q.clone(), k.clone(), v.clone())
            return lambda: sdpa(*a, is_causal=False)

        t["device_ms"], t["cold_ms"] = device_times(kernel, bytes_moved)
        t["library_device_ms"], t["library_cold_ms"] = device_times(
            library, bytes_moved)
        log(f"  prefill {label} bf16: back-to-back {t['ms']:.4f} ms kernel, "
            f"{t['plain_ms']:.4f} ms plain, {t['library_ms']:.4f} ms SDPA; "
            f"device-only kernel {t['device_ms']:.5f} ms warm, "
            f"{t['cold_ms']:.5f} ms L2-cold; SDPA "
            f"{t['library_device_ms']:.5f} / {t['library_cold_ms']:.5f} ms; "
            f"bound {bound_ms:.5f} ms ({bound_by})")
        out["flash_attention"].update({f"{label}_{k}": v
                                       for k, v in t.items()})

    log(f"ring decode (whisper cross lanes): B={b} KH={h} G=1 dh={dh} W={f} "
        f"pos={f - 1} (every row visible)")
    q32 = torch.randn(b, h, dh, device=dev)
    kl32 = torch.randn(b, h, f, dh, device=dev)
    vl32 = torch.randn(b, h, f, dh, device=dev)
    slots = torch.as_tensor(np.random.default_rng(SEED).permutation(b),
                            dtype=torch.int32, device=dev)
    ps = torch.full((b,), f - 1, dtype=torch.int32, device=dev)
    idx = slots.long()
    for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        t = getattr(torch, dt)
        args = (q32.to(t), kl32.to(t), vl32.to(t), slots, ps)
        out_k = ring_decode_attention(*args)
        torch.cuda.synchronize()
        err = check_close(f"ring decode whisper cross lanes {dt}", out_k,
                          ring_decode_attention_plain(*args), tol)
        unmasked = flash_attention_plain(
            args[0][:, :, None], args[1][idx], args[2][idx], zero, full,
            causal=False)[:, :, 0]
        check_close(f"ring decode whisper cross lanes vs unmasked attention "
                    f"{dt}", out_k, unmasked, tol)
    q, kl, vl = q32.to(bf), kl32.to(bf), vl32.to(bf)
    qs, ke, ve = q[:, :, None, :], kl[idx].contiguous(), vl[idx].contiguous()
    bytes_moved = 2 * b * h * f * dh * 2 + 2 * b * h * dh * 2 + 2 * b * 4
    bound_ms, bound_by = bound(bytes_moved, 4 * b * h * f * dh)
    t = {"max_abs_err": err,
         "ms": cuda_ms(lambda: ring_decode_attention(q, kl, vl, slots, ps),
                       200),
         "plain_ms": cuda_ms(lambda: ring_decode_attention_plain(
             q, kl, vl, slots, ps), 20),
         "library_ms": cuda_ms(lambda: sdpa(qs, ke, ve), 200),
         "bound_ms": bound_ms, "bound_by": bound_by}

    def kernel(i):
        a = (q, kl, vl) if i == 0 else (q.clone(), kl.clone(), vl.clone())
        return lambda: ring_decode_attention(*a, slots, ps)

    def library(i):
        a = (qs, ke, ve) if i == 0 else (qs.clone(), ke.clone(), ve.clone())
        return lambda: sdpa(*a)

    t["device_ms"], t["cold_ms"] = device_times(kernel, bytes_moved)
    t["library_device_ms"], t["library_cold_ms"] = device_times(
        library, bytes_moved)
    log(f"  ring decode whisper cross lanes bf16: back-to-back "
        f"{t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms plain, "
        f"{t['library_ms']:.4f} ms SDPA; device-only kernel "
        f"{t['device_ms']:.5f} ms warm, {t['cold_ms']:.5f} ms L2-cold; SDPA "
        f"{t['library_device_ms']:.5f} / {t['library_cold_ms']:.5f} ms; "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    out["ring_decode_attention"].update({f"whisper_cross_{k}": v
                                         for k, v in t.items()})
    return out


# ---------------------------------------------------------------------------
# Latent attention (MLA): Moonlight-16B-A3B's two kernels
# ---------------------------------------------------------------------------
MLA_HEADS, MLA_KD, MLA_VD = 16, 576, 512   # latent rows; V their first 512
MLA_QK, MLA_V = 192, 128                   # non-absorbed prefill widths
MLA_BS, MLA_TABLE = 16, 128                # 16-row blocks, 2,048 positions


def _latent_inputs(gen, dev, lengths, heads=MLA_HEADS):
    """Absorbed queries (``heads`` of them), a latent pool, tables and
    lengths as the served path holds them: each row on blocks of its own
    in shuffled order, the table's other entries on the null block (the
    pool's last)."""
    bf = torch.bfloat16
    used = [-(-n // MLA_BS) for n in lengths]
    n = sum(used)
    pool = torch.randn(n + 1, MLA_BS, MLA_KD, generator=gen, device=dev)
    tables = torch.full((len(lengths), MLA_TABLE), n, dtype=torch.int32,
                        device=dev)
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    at = 0
    for i, u in enumerate(used):
        tables[i, :u] = perm[at:at + u]
        at += u
    q = torch.randn(len(lengths), heads, MLA_KD, generator=gen, device=dev)
    return (q.to(bf), pool.to(bf), tables,
            torch.as_tensor(lengths, dtype=torch.int32, device=dev))


def check_fault(name: str, fault, right, tol: float) -> float:
    """A planted fault's output must fall outside the tolerance that the
    kernel is held to, or the check could not see such a kernel."""
    err = (fault.float() - right.float()).abs().max().item()
    if torch.allclose(fault.float(), right.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: the planted fault passes tol {tol:g} "
                             f"(max_abs_err {err:.3e})")
    log(f"  {name}: max_abs_err={err:.3e}, outside tol {tol:g}")
    return err


def _latent_timings(gen, dev, h: int, scale: float, length: int = 160):
    """The latent decode kernel at ``h`` heads timed at 1, 16 and 64 rows of
    ``length`` positions: device-only (L2-warm and cold), back-to-back,
    the plain version, and the bound. Returns the timings by rows and the
    64 rows' inputs."""
    from repro_torch.kernels.flash_decode.ops import (
        latent_decode_attention, latent_decode_attention_plain)

    timed = {}
    for b in (1, 16, 64):
        made = {0: _latent_inputs(gen, dev, [length] * b, h)}

        def call(i, made=made, b=b):
            if i not in made:
                made[i] = _latent_inputs(gen, dev, [length] * b, h)
            return lambda: latent_decode_attention(*made[i], MLA_VD, scale)
        rows_bytes = b * length * MLA_KD * 2
        nbytes = (rows_bytes + b * h * (MLA_KD + MLA_VD) * 2
                  + b * 4 + b * -(-length // MLA_BS) * 4)
        t = {"rows": b, "length": length}
        t["device_ms"], t["cold_ms"] = device_times(call, rows_bytes)
        t["ms"] = cuda_ms(call(0), 200)
        t["plain_ms"] = cuda_ms(lambda: latent_decode_attention_plain(
            *made[0], MLA_VD, scale), 10)
        t["bound_ms"], t["bound_by"] = bound(
            nbytes, 2 * h * (MLA_KD + MLA_VD) * b * length)
        log(f"  latent decode H {h} bf16, {b} rows of {length}: device-only "
            f"{t['device_ms']:.5f} ms warm, {t['cold_ms']:.5f} ms L2-cold; "
            f"back-to-back {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
        timed[b] = t
    return timed, made[0]


def phase_latent_decode_kernel(dev) -> dict:
    """The latent decode kernel at Moonlight's served shape (16 heads over
    576-wide rows, V their first 512, scale 1/sqrt(192); 16-row blocks,
    2,048-position tables) in bf16 against its plain version at 2e-2: 64
    rows at served lengths (70-250), one row, lengths around the split
    boundaries and the full table; then rows whose newest row (the token's
    own) carries about half the weight, where two planted faults must fall
    outside the tolerance (a length one short, the scale 1/sqrt(576)).
    Timed at 1, 16 and 64 rows of 160 positions as the record's rows are."""
    from repro_torch.kernels.flash_decode.ops import (
        latent_decode_attention, latent_decode_attention_plain,
        split_geometry)

    entries, splits = split_geometry(MLA_BS, MLA_TABLE)
    split, full = entries * MLA_BS, MLA_TABLE * MLA_BS
    scale, tol = MLA_QK ** -0.5, 2e-2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    served = (70 + rng.integers(0, 181, 64)).tolist()
    edges = [0, 1, split - 1, split, split + 1, 3 * split, full - 1, full]
    log(f"latent decode: H={MLA_HEADS} rows of {MLA_KD} (V {MLA_VD}) "
        f"scale 1/sqrt({MLA_QK}) bs={MLA_BS} max_blocks={MLA_TABLE} "
        f"({splits} splits of {split} rows); edge lengths {edges}")

    def both(args, s=scale):
        out = latent_decode_attention(*args, MLA_VD, s)
        torch.cuda.synchronize()
        return out, latent_decode_attention_plain(*args, MLA_VD, s)

    err = 0.0
    for label, lengths in (("served lengths, 64 rows", served),
                           ("one row", [160]), ("edge lengths", edges)):
        err = max(err, check_close(f"latent decode {label} bf16",
                                   *both(_latent_inputs(gen, dev, lengths)),
                                   tol))
    q, pool, tables, lens = args = _latent_inputs(gen, dev, served[:16])
    for i, n in enumerate(lens.tolist()):
        pool[int(tables[i, (n - 1) // MLA_BS]), (n - 1) % MLA_BS] = \
            2.5 * q[i].float().mean(0)
    out, right = both(args)
    err = max(err, check_close("latent decode, newest row weighing half",
                               out, right, tol))
    check_fault("fault: a length one short", latent_decode_attention_plain(
        q, pool, tables, lens - 1, MLA_VD, scale), right, tol)
    check_fault("fault: scale 1/sqrt(576)", latent_decode_attention_plain(
        q, pool, tables, lens, MLA_VD, MLA_KD ** -0.5), right, tol)

    timed, args64 = _latent_timings(gen, dev, MLA_HEADS, scale)
    t = timed[64]
    return {"name": "latent_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode_latent.cu",
            "replaces": "none (the JAX package has no latent attention)",
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "device_ms": t["device_ms"],
            "cold_ms": t["cold_ms"],
            "by_rows": {str(b): t for b, t in timed.items()},
            "call": lambda: latent_decode_attention(*args64, MLA_VD, scale)}


KIMI_HEADS = 64
KIMI_SCALE = MLA_QK ** -0.5 * (0.1 * math.log(32.0) + 1.0) ** 2  # 0.130861


def phase_latent_decode_kernel_64(dev) -> dict:
    """The latent decode kernel's 64-head instance (Kimi K2: four M-tiles
    of 16 heads over the same shared rows) at YaRN's scale in bf16
    against its plain version at 2e-2: 1, 16 and 64 rows at positions 159
    and 2,047 (the full table); a planted fault (the scale without
    mscale^2) must fall outside the tolerance. Timed at 1, 16 and 64 rows
    of 160 positions as row 5 is. Returns ``h64_*`` keys for the latent
    kernel's entry."""
    from repro_torch.kernels.flash_decode.ops import (
        latent_decode_attention, latent_decode_attention_plain)

    h, scale, tol = KIMI_HEADS, KIMI_SCALE, 2e-2
    gen = torch.Generator(device=dev).manual_seed(SEED + 64)
    log(f"latent decode: H={h} rows of {MLA_KD} (V {MLA_VD}) scale "
        f"{scale:.6f} bs={MLA_BS} max_blocks={MLA_TABLE}")

    def both(args, s=scale):
        out = latent_decode_attention(*args, MLA_VD, s)
        torch.cuda.synchronize()
        return out, latent_decode_attention_plain(*args, MLA_VD, s)

    err = 0.0
    for b in (1, 16, 64):
        for position in (159, 2047):
            args = _latent_inputs(gen, dev, [position + 1] * b, h)
            out, right = both(args)
            err = max(err, check_close(
                f"latent decode H {h}, {b} rows at {position} bf16", out,
                right, tol))
    check_fault("fault: the scale without mscale^2",
                latent_decode_attention_plain(*args, MLA_VD, MLA_QK ** -0.5),
                right, tol)
    timed, _ = _latent_timings(gen, dev, h, scale)
    return {"h64_max_abs_err": err,
            "h64_by_rows": {str(b): t for b, t in timed.items()}}


def phase_prefill_mla_instance(dev, h=MLA_HEADS, scale=None) -> dict:
    """The prefill kernel's (192, 128) instance (MLA's non-absorbed
    prefill, H = KH = ``h``, bf16; the softmax scale ``scale``, or
    1/sqrt(192)) against its plain version at 2e-2: first
    chunks of 1 to 512 tokens and continuation chunks at per-row offsets
    over longer lanes, as ``forward_chunk`` gathers them; two planted
    faults must fall outside the tolerance (the scale 1/sqrt(128), the
    causal mask one position late). Timed on first chunks of 8 x 128,
    1 x 512 and 4 x 512 beside SDPA. Returns keys for the prefill kernel's
    entry (``mla_*``, ``mla_h64_*`` at 64 heads)."""
    from repro_torch.kernels.flash_prefill.ops import (flash_attention,
                                                       flash_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    tol = 2e-2
    key = "mla" if h == MLA_HEADS else f"mla_h{h}"

    def inputs(b, sq, skv, starts, lens):
        r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(  # noqa
            torch.bfloat16)
        i32 = lambda x: torch.as_tensor(x, dtype=torch.int32,  # noqa: E731
                                        device=dev)
        return (r(b, h, sq, MLA_QK), r(b, h, skv, MLA_QK), r(b, h, skv, MLA_V),
                i32(starts), i32(lens))

    def both(args):
        out = flash_attention(*args, scale=scale)
        torch.cuda.synchronize()
        return out, flash_attention_plain(*args, scale=scale)

    log(f"prefill MLA instance: H = KH = {h}, QK {MLA_QK}, V {MLA_V}, bf16, "
        f"scale {scale or MLA_QK ** -0.5:.6f}")
    err = 0.0
    for b, s in ((8, 128), (1, 512), (4, 512), (3, 1), (2, 7)):
        err = max(err, check_close(
            f"prefill MLA first chunks {b} x {s}",
            *both(inputs(b, s, s, [0] * b, [s] * b)), tol))
    starts = [0, 16, 64, 128, 192, 256, 384, 448]
    err = max(err, check_close(
        "prefill MLA continuation chunks of 64 over 512-row lanes",
        *both(inputs(8, 64, 512, starts, [s + 64 for s in starts])), tol))
    err = max(err, check_close(
        "prefill MLA continuation chunks of 512 at 512 over 1,024 rows",
        *both(inputs(2, 512, 1024, [512, 512], [1024, 1024])), tol))
    q, k, v, qs, kl = args = inputs(8, 128, 128, [0] * 8, [128] * 8)
    _, right = both(args)
    check_fault("fault: scale 1/sqrt(128)", flash_attention_plain(
        (q.float() * (MLA_QK / MLA_V) ** 0.5).to(q.dtype), k, v, qs, kl,
        scale=scale), right, tol)
    check_fault("fault: the causal mask one position late",
                flash_attention_plain(q, k, v, qs + 1, kl, scale=scale),
                right, tol)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = []
    for b, s in ((8, 128), (1, 512), (4, 512)):
        made = {0: inputs(b, s, s, [0] * b, [s] * b)}

        def copy(i, made=made, b=b, s=s):
            if i not in made:
                made[i] = inputs(b, s, s, [0] * b, [s] * b)
            return made[i]
        nbytes = b * h * s * (2 * MLA_QK + 2 * MLA_V) * 2
        t = {"rows": b, "tokens": s}
        t["device_ms"], t["cold_ms"] = device_times(
            lambda i: (lambda a=copy(i): flash_attention(*a, scale=scale)),
            nbytes)
        t["library_device_ms"], t["library_cold_ms"] = device_times(
            lambda i: (lambda a=copy(i): sdpa(a[0], a[1], a[2],
                                             is_causal=True, scale=scale)),
            nbytes)
        a = made[0]
        t["ms"] = cuda_ms(lambda: flash_attention(*a, scale=scale), 100)
        t["plain_ms"] = cuda_ms(lambda: flash_attention_plain(
            *a, scale=scale), 5)
        t["library_ms"] = cuda_ms(lambda: sdpa(a[0], a[1], a[2],
                                               is_causal=True, scale=scale),
                                  100)
        t["bound_ms"], t["bound_by"] = bound(
            nbytes, 2 * h * (MLA_QK + MLA_V) * b * s * (s + 1) // 2)
        log(f"  prefill MLA bf16 {b} x {s}: device-only {t['device_ms']:.5f}"
            f" ms warm, {t['cold_ms']:.5f} ms L2-cold; SDPA "
            f"{t['library_device_ms']:.5f} / {t['library_cold_ms']:.5f} ms; "
            f"back-to-back {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"SDPA {t['library_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})")
        timed.append(t)
    return {"flash_attention": {f"{key}_max_abs_err": err,
                                f"{key}_timed": timed}}


SLOT_SHAPES = ((1, 512, 8, 64), (1, 512, 6, 64), (1, 512, 8, 384),
               (64, 1, 8, 64))   # (G, T, k, E) of the MoE dispatches


def phase_slot_positions_kernel(dev) -> dict:
    """``slot_positions`` at each (G, T, k, E) of ``SLOT_SHAPES``, read from
    a view of the router's sorted experts as ``_dispatch`` passes it:
    bitwise against its plain version (the one-hot ``cumsum``), then timed
    back to back (``ms``, ``plain_ms``) and device-only from a graph
    replay (``device_ms``, ``plain_device_ms``) with its inputs in L2, as
    the router has just written them, beside the byte bound: each slot's
    expert read and its place written, 8 bytes each."""
    from repro_torch.kernels.moe_route.ops import (slot_positions,
                                                   slot_positions_plain)

    rng = np.random.default_rng(SEED)
    by_shape, calls = {}, {}
    for g, t, k, e in SLOT_SHAPES:
        order = torch.from_numpy(np.argsort(rng.random((g, t, e)), -1))
        gate = order.to(dev)[..., :k]
        got = slot_positions(gate, e)
        torch.cuda.synchronize()
        if not torch.equal(got, slot_positions_plain(gate, e)):
            raise AssertionError(f"slot_positions at (G, T, k, E) "
                                 f"{(g, t, k, e)} differs from the plain "
                                 f"version")
        kernel = functools.partial(slot_positions, gate, e)
        plain = functools.partial(slot_positions_plain, gate, e)
        bound_ms, bound_by = bound(16 * g * t * k, 0)
        label = f"G{g} T{t} k{k} E{e}"
        calls[label] = kernel
        by_shape[label] = row = {
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms([kernel]),
            "plain_device_ms": device_ms([plain]),
            "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"  slot_positions {label}: bitwise equal; device-only "
            f"{row['device_ms']:.5f} ms (plain {row['plain_device_ms']:.5f}"
            f"), back-to-back {row['ms']:.5f} ms (plain "
            f"{row['plain_ms']:.5f}); bound {bound_ms:.6f} ms ({bound_by})")
    first = by_shape["G1 T512 k8 E64"]
    return {"name": "slot_positions", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_slots.cu",
            "replaces": "none (the JAX package's one-hot cumsum in "
                        "apply_moe, left to XLA)",
            "max_abs_err": 0.0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None,
            "device_ms": first["device_ms"], "by_shape": by_shape,
            "call": calls["G1 T512 k8 E64"]}


def phase_ring_decode_kernel(dev):
    from repro_torch.kernels.flash_decode.ops import (
        ring_decode_attention, ring_decode_attention_plain)
    from repro_torch.models.attention import ring_slot_positions

    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry = None
    # (label, B, KH, G, dh, W, window, per-row pos): Hymba's lanes with most
    # rows wrapped, and a dense model's lanes (llama3_2_3b, paged=False)
    for label, b, kh, g, dh, w, window, pos in (
            ("hymba", 8, 5, 5, 64, 1024, 1024,
             [3, 800, 1100, 1500, 1900, 2300, 2700, 3000]),
            ("dense", 8, 8, 3, 128, 512, None,
             [0, 17, 100, 255, 256, 400, 511, 700])):
        h = kh * g
        log(f"ring decode ({label}): B={b} KH={kh} G={g} dh={dh} W={w} "
            f"window={window} pos={pos}")
        q32 = torch.randn(b, h, dh, device=dev)
        kl32 = torch.randn(b, kh, w, dh, device=dev)
        vl32 = torch.randn(b, kh, w, dh, device=dev)
        slots = torch.as_tensor(np.random.default_rng(SEED).permutation(b),
                                dtype=torch.int32, device=dev)
        ps = torch.tensor(pos, dtype=torch.int32, device=dev)
        errs = {}
        for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            t = getattr(torch, dt)
            args = (q32.to(t), kl32.to(t), vl32.to(t), slots, ps)
            out = ring_decode_attention(*args, window=window)
            torch.cuda.synchronize()
            errs[dt] = check_close(
                f"ring decode {label} {dt}", out,
                ring_decode_attention_plain(*args, window=window), tol)
        bf = torch.bfloat16
        q, kl, vl = q32.to(bf), kl32.to(bf), vl32.to(bf)
        ms = cuda_ms(lambda: ring_decode_attention(q, kl, vl, slots, ps,
                                                   window=window), 200)
        plain_ms = cuda_ms(lambda: ring_decode_attention_plain(
            q, kl, vl, slots, ps, window=window), 20)
        # library yardstick: SDPA over the rows' lanes, gathered and with
        # heads expanded outside the timed call, the ring mask as bool
        idx = slots.long()
        ke = kl[idx].repeat_interleave(g, 1).contiguous()
        ve = vl[idx].repeat_interleave(g, 1).contiguous()
        slot_pos = ring_slot_positions(ps.long() + 1, w)
        mask = slot_pos >= 0
        if window is not None:
            mask = mask & (ps.long()[:, None] - slot_pos < window)
        mask = mask[:, None, None, :]
        qs = q[:, :, None, :]
        library_ms = cuda_ms(lambda: sdpa(qs, ke, ve, attn_mask=mask), 200)
        rows = int(mask.sum())                      # keys that count
        bytes_moved = (2 * rows * kh * dh * 2        # K and V rows, bf16
                       + 2 * b * h * dh * 2 + 2 * b * 4)
        flops = 4 * rows * h * dh
        bound_ms, bound_by = bound(bytes_moved, flops)
        log(f"  ring decode {label} bf16: {ms:.4f} ms kernel, {plain_ms:.4f} "
            f"ms plain, {library_ms:.4f} ms SDPA, bound {bound_ms:.5f} ms "
            f"({bound_by})")
        if entry is None:       # the served path's shape goes to the record
            def kernel(i):
                a = (q, kl, vl) if i == 0 else (q.clone(), kl.clone(),
                                                vl.clone())
                return lambda: ring_decode_attention(*a, slots, ps,
                                                     window=window)

            def library(i):
                a = (qs, ke, ve) if i == 0 else (qs.clone(), ke.clone(),
                                                 ve.clone())
                return lambda: sdpa(*a, attn_mask=mask)

            t = {}
            t["device_ms"], t["cold_ms"] = device_times(kernel, bytes_moved)
            t["library_device_ms"], t["library_cold_ms"] = device_times(
                library, 2 * (ke.numel() + ve.numel()))
            log(f"  ring decode {label} bf16, device-only: kernel "
                f"{t['device_ms']:.5f} ms warm, {t['cold_ms']:.5f} ms "
                f"L2-cold; SDPA {t['library_device_ms']:.5f} / "
                f"{t['library_cold_ms']:.5f} ms")
            entry = {"name": "ring_decode_attention", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                     "replaces": "src/repro/kernels/flash_decode/kernel.py:87",
                     "max_abs_err": errs["bfloat16"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms, **t,
                     "call": functools.partial(
                         ring_decode_attention, q, kl, vl, slots, ps,
                         window=window)}
    _ring_edges(dev)
    return entry


def _ring_edges(dev):
    """Ring decode at its split edges (pos 0, 1, 63, 64, 65 unwrapped;
    W-1, W, W+63, 3W+64 wrapped), with and without a window shorter than
    the lane, and two rows reading one lane at one pos bitwise equal."""
    from repro_torch.kernels.flash_decode.ops import (
        ring_decode_attention, ring_decode_attention_plain,
        ring_split_geometry)

    kh, g, dh = 5, 5, 64
    for w, window in ((256, None), (256, 100), (1024, 1024), (64, 40)):
        pos = [0, 1, 63, 64, 65, w - 1, w, w + 63, 3 * w + 64]
        b = len(pos)
        q32 = torch.randn(b, kh * g, dh, device=dev)
        kl32 = torch.randn(b + 1, kh, w, dh, device=dev)
        vl32 = torch.randn(b + 1, kh, w, dh, device=dev)
        slots = torch.arange(b, 0, -1, dtype=torch.int32, device=dev)
        ps = torch.tensor(pos, dtype=torch.int32, device=dev)
        for dt, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
            t = getattr(torch, dt)
            args = (q32.to(t), kl32.to(t), vl32.to(t), slots, ps)
            out = ring_decode_attention(*args, window=window)
            torch.cuda.synchronize()
            check_close(f"ring decode W={w} ({ring_split_geometry(w)[1]} "
                        f"splits) window={window} pos={pos} {dt}", out,
                        ring_decode_attention_plain(*args, window=window),
                        tol)
    w = 192
    q = torch.randn(4, kh * g, dh, device=dev)
    q[2] = q[0]
    lanes = torch.randn(3, kh, w, dh, device=dev)
    slots = torch.tensor([1, 0, 1, 2], dtype=torch.int32, device=dev)
    ps = torch.tensor([2 * w + 70, 5, 2 * w + 70, 900], dtype=torch.int32,
                      device=dev)
    for t in (torch.float32, torch.bfloat16):
        out = ring_decode_attention(q.to(t), lanes.to(t), lanes.to(t), slots,
                                    ps, window=150)
        torch.cuda.synchronize()
        if not torch.equal(out[0], out[2]):
            raise AssertionError(f"ring decode: rows on one slot and pos "
                                 f"are not bitwise equal ({t})")
    log(f"  ring decode aliased slots (W={w}, pos {2 * w + 70}, window 150, "
        f"3 splits): bitwise equal, f32 and bf16")


def _recurrence(q, k, v, lw, bonus, mode):
    """Token-by-token scan (the port's one-step update): the oracle the
    chunked kernel is held against, independent of chunking."""
    from repro_torch.models.linear_attn import linear_attention_step

    b, h, t, dk = q.shape
    state = torch.zeros(b, h, dk, v.shape[-1], device=q.device)
    outs = []
    for i in range(t):
        o, state = linear_attention_step(state, q[:, :, i], k[:, :, i],
                                         v[:, :, i], lw[:, :, i],
                                         bonus=bonus, mode=mode)
        outs.append(o)
    return torch.stack(outs, 2), state


def _linear_checks(label, q32, k32, v32, lw, u, mode) -> float:
    """The chunked kernel against its plain version and a token recurrence:
    f32 output and final state at 5e-4, bf16 output at 2e-2 and its final
    state at 5e-4. Returns the f32 error."""
    from repro_torch.kernels.rwkv6_chunk.ops import linear_attention
    from repro_torch.models.linear_attn import chunked_linear_attention

    tol = 5e-4
    out, state = linear_attention(q32, k32, v32, lw, u, mode=mode)
    torch.cuda.synchronize()
    ref, ref_state = chunked_linear_attention(q32, k32, v32, lw, bonus=u,
                                              mode=mode, chunk_size=64)
    rec, rec_state = _recurrence(q32, k32, v32, lw, u, mode)
    err = max(check_close(f"{label} f32 vs plain", out, ref, tol),
              check_close(f"{label} f32 final state vs plain", state,
                          ref_state, tol),
              check_close(f"{label} f32 vs recurrence", out, rec, tol),
              check_close(f"{label} f32 final state vs recurrence", state,
                          rec_state, tol))
    bf = torch.bfloat16
    q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
    out, state = linear_attention(q, k, v, lw, u, mode=mode)
    torch.cuda.synchronize()
    ref, ref_state = chunked_linear_attention(q, k, v, lw, bonus=u,
                                              mode=mode, chunk_size=64)
    check_close(f"{label} bf16 vs plain", out, ref, 2e-2)
    check_close(f"{label} bf16 final state vs plain", state, ref_state, tol)
    return err


def phase_linear_attention_kernel(dev):
    from repro_torch.kernels.rwkv6_chunk.ops import (
        kernel_occupancy, linear_attention, tf32_tile_check,
        tf32_tile_check_plain)
    from repro_torch.models.linear_attn import (MAX_LOG_DECAY,
                                                chunked_linear_attention)

    # the 3xTF32 products and fragment layouts, bare, on one 64 x 64 tile
    tile = [torch.randn(64, 64, device=dev) / 8 for _ in range(3)]
    got = tf32_tile_check(*tile)
    torch.cuda.synchronize()
    s_ref, _, u_ref = tf32_tile_check_plain(*tile)
    check_close("3xTF32 tile: S = A B^T", got[0], s_ref, 1e-5)
    check_close("3xTF32 tile: O = S C", got[1], got[0] @ tile[2], 1e-5)
    check_close("3xTF32 tile: U = A^T C", got[2], u_ref, 1e-5)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    entry = None
    # Hymba's SSD heads at a 128-token bucket (the record's shape), RWKV-6
    # 7B's heads at its served prefill shape (8 prompts of 128 tokens), and
    # at 4 x 256 tokens
    for mode, b, h, t, dk, dv in (("ssd", 8, 50, 128, 16, 64),
                                  ("rwkv", 8, 64, 128, 64, 64),
                                  ("rwkv", 4, 64, 256, 64, 64)):
        lw_dim = dk if mode == "rwkv" else 1
        occ = {dt: kernel_occupancy(getattr(torch, dt), 64, dk, dv, lw_dim)
               for dt in ("bfloat16", "float32")}
        log(f"linear attention ({mode}): B={b} H={h} T={t} dk={dk} dv={dv} "
            f"chunk 64; shared memory per block and blocks per SM (bf16, "
            f"f32): {occ}; {b * h} blocks")
        q32 = torch.randn(b, h, t, dk, device=dev, generator=gen)
        k32 = torch.randn(b, h, t, dk, device=dev, generator=gen)
        v32 = torch.randn(b, h, t, dv, device=dev, generator=gen)
        lw = -torch.rand(b, h, t, lw_dim, device=dev,
                         generator=gen).clamp(min=1e-6)    # [-1, 0)
        u = (torch.randn(h, dk, device=dev, generator=gen) * 0.1
             if mode == "rwkv" else None)
        err = _linear_checks(mode, q32, k32, v32, lw, u, mode)
        # every step's log-decay at the contract's edge: exp(+-inc) spans
        # e^+-64 inside a chunk
        err = max(err, _linear_checks(
            f"{mode} log-decay -{MAX_LOG_DECAY:g}", q32, k32, v32,
            torch.full_like(lw, -MAX_LOG_DECAY), u, mode))
        bf = torch.bfloat16
        q, k, v = q32.to(bf), k32.to(bf), v32.to(bf)
        ms = cuda_ms(lambda: linear_attention(q, k, v, lw, u, mode=mode), 100)
        plain_ms = cuda_ms(lambda: chunked_linear_attention(
            q, k, v, lw, bonus=u, mode=mode, chunk_size=64), 20)
        c = 64
        bytes_moved = (2 * (2 * b * h * t * dk + b * h * t * dv)   # q, k, v
                       + 4 * lw.numel() + 2 * b * h * t * dv       # lw, out
                       + 4 * b * h * dk * dv                       # state
                       + (4 * h * dk if u is not None else 0))
        flops = b * h * (t // c) * (c * (c - 1) * (dk + dv)    # scores, P V
                                    + 4 * c * dk * dv          # state in/out
                                    + 2 * c * (dk + dv))       # diagonal
        bound_ms, bound_by = bound(bytes_moved, flops)
        log(f"  {mode} B={b} T={t} bf16: {ms:.4f} ms kernel, {plain_ms:.4f} "
            f"ms plain, no library call, bound {bound_ms:.5f} ms "
            f"({bound_by}, {bytes_moved / 1e6:.2f} MB)")
        if entry is not None and (b, t) != (8, 128):
            continue

        def kernel(i, q=q, k=k, v=v, lw=lw, u=u, mode=mode):
            a = (q, k, v, lw) if i == 0 else tuple(
                x.clone() for x in (q, k, v, lw))
            return lambda: linear_attention(*a, u, mode=mode)

        dev_t = {}
        dev_t["device_ms"], dev_t["cold_ms"] = device_times(kernel,
                                                            bytes_moved)
        log(f"  {mode} bf16, device-only: kernel {dev_t['device_ms']:.5f} ms "
            f"warm, {dev_t['cold_ms']:.5f} ms L2-cold")
        if entry is not None:   # rwkv mode at RWKV-6 7B's served shape
            entry.update({"rwkv_max_abs_err": err, "rwkv_ms": ms,
                          "rwkv_plain_ms": plain_ms,
                          "rwkv_bound_ms": bound_ms,
                          "rwkv_bound_by": bound_by,
                          **{f"rwkv_{k}": v for k, v in dev_t.items()}})
        else:                   # Hymba's ssd mode: the record's shape
            entry = {"name": "linear_attention", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/rwkv6_chunk.cu",
                     "replaces": "src/repro/kernels/rwkv6_chunk/kernel.py:75",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, **dev_t,
                     "call": kernel(0)}
    return entry


# ---------------------------------------------------------------------------
# Phases 3 and 4: the served paths
# ---------------------------------------------------------------------------
def _words(n: int, tag: str) -> str:
    return " ".join(f"{tag}{j}" for j in range(n))


def burst(n: int = 16, seed: int = SEED):
    """``n`` requests at t=0; every other one opens with a shared ~90-word
    system prompt, and output lengths are drawn from 1..64."""
    from repro_torch.core.scheduler.request import Request
    from repro_torch.data.synthetic import make_corpus

    rng = np.random.default_rng(seed)
    system = "system " + _words(90, "rule")
    corpus = make_corpus("alpaca", n, seed=seed)
    reqs = []
    for i, question in enumerate(corpus.prompts):
        prompt = f"{system} {question}" if i % 2 == 0 else question
        reqs.append(Request(req_id=i, prompt=prompt, arrival_time=0.0,
                            prompt_len=len(prompt.split()),
                            true_length=int(rng.integers(1, 65))))
    return reqs


# Per served architecture: the engine settings of its burst. llama3_2_3b
# serves from a paged pool with chunked prefill and prefix caching under a
# 64-block budget (admission comes in waves, so later requests hit the
# committed system prompt whatever order PARS picks); hymba_1_5b, a hybrid,
# serves from contiguous ring lanes (no chunking or caching, which its SSM
# state forbids) 128 positions wide, so the longer outputs wrap the ring,
# under a budget that admits all 8 slots at full demand (128 + 64 positions
# in 16-token blocks each); rwkv6_7b, attention-free, keeps only per-slot
# recurrent state (no chunking or caching either) under the same budget.
# olmoe_1b_7b (MoE) and qwen2_vl_72b's backbone (VLM) serve as llama3_2_3b
# does, so continuation chunks and prefix-hit suffixes run their layers
# through forward_chunk. moonlight_16b_a3b (MLA) serves from the benchmark
# cell's latent pool (2,048 positions, 8,192 blocks) with llama's chunks.
SERVED = {
    "llama3_2_3b": dict(cache_len=512, chunk=64, caching=True, kv_blocks=64),
    "olmoe_1b_7b": dict(cache_len=512, chunk=64, caching=True, kv_blocks=64),
    "qwen2_vl_72b": dict(cache_len=512, chunk=64, caching=True,
                         kv_blocks=64),
    "hymba_1_5b": dict(cache_len=128, chunk=None, caching=False,
                       kv_blocks=8 * 12),
    "rwkv6_7b": dict(cache_len=512, chunk=None, caching=False,
                     kv_blocks=8 * 12),
    "moonlight_16b_a3b": dict(cache_len=2048, chunk=64, caching=True,
                              kv_blocks=8192),
    "kimi_k2_instruct": dict(cache_len=2048, chunk=64, caching=True,
                             kv_blocks=8192),
}


def make_engine(cfg, params, policy, dev, *, chunk, caching, kv_blocks,
                cache_len, max_batch=8, prompt_len=128):
    from repro_torch.core.scheduler.scheduler import Scheduler
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import BlockAllocator

    return Engine(cfg, params, Scheduler(policy=policy, max_batch=max_batch),
                  cache_len=cache_len, prompt_len=prompt_len,
                  allocator=BlockAllocator(kv_blocks, 16),
                  prefill_chunk_tokens=chunk, prefix_caching=caching,
                  record_tokens=True, device=dev)


def phase_parity(dev) -> float:
    """Full-width llama3_2_3b cut to 4 layers, f32, TF32 off."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler.policies import fcfs
    from repro_torch.models import transformer as tfm

    cfg = get_config("llama3_2_3b").replace(num_layers=4, dtype="float32")
    params = tfm.init_params(cfg, SEED, device=dev)
    runs = {}
    for chunk, caching in ((None, False), (64, True)):
        eng = make_engine(cfg, params, fcfs(), dev, chunk=chunk,
                          caching=caching, kv_blocks=64, cache_len=512)
        eng.submit(burst(12))
        fin = eng.run()
        if len(fin) != 12 or eng.allocator.used_blocks:
            raise AssertionError(f"parity run {chunk, caching}: "
                                 f"{len(fin)} finished, "
                                 f"{eng.allocator.used_blocks} blocks held")
        runs[chunk, caching] = {r.req_id: r.generated_tokens for r in fin}
        log(f"  4-layer f32 run chunk={chunk} caching={caching}: "
            f"{eng.backend.prefill_dispatches} prefill + "
            f"{eng.backend.extend_dispatches} extend dispatches, "
            f"{eng.backend.prefix_installs} prefix hits")
        if caching and eng.backend.prefix_installs == 0:
            raise AssertionError("parity run: no prefix-cache hit")
    if runs[None, False] != runs[64, True]:
        diff = [i for i in runs[None, False]
                if runs[None, False][i] != runs[64, True].get(i)]
        raise AssertionError(f"chunked+cached tokens differ for {diff}")
    log("  greedy tokens: chunked + prefix-cached == unchunked + uncached")

    # the same model on the CPU, through the plain versions
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))

    def run(tree, device):
        cache = tfm.init_cache(cfg, 2, 64, device=device)
        lg, cache, _ = tfm.forward_seq(tree, cfg, toks[:, :20].to(device),
                                       cache=cache)
        lg2, _, _ = tfm.forward_chunk(tree, cfg, toks[:, 20:].to(device),
                                      cache)
        return lg.cpu(), lg2.cpu()

    lg, lg2 = run(params, dev)
    ref, ref2 = run(_tree_to(params, "cpu"), torch.device("cpu"))
    err = max(check_close("4-layer logits card vs CPU, prefill", lg, ref,
                          1e-3),
              check_close("4-layer logits card vs CPU, chunk", lg2, ref2,
                          1e-3))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("non-finite logits")
    return err


def phase_recurrent_parity(dev, arch: str, steps: int) -> float:
    """Full-width ``arch`` (hymba_1_5b or rwkv6_7b) cut to 4 layers, f32,
    TF32 off: a 32-token prefill into a 64-position cache, then ``steps``
    greedy decode steps (past 64, Hymba's ring lanes wrap); every step's
    logits on the card agree with the CPU's at 1e-3, and the greedy tokens
    are equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_chunk.ops import linear_attention
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch).replace(num_layers=4, dtype="float32")
    params = tfm.init_params(cfg, SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)))
    width = 64

    def run(tree, device):
        cache = tfm.init_cache(cfg, 2, width, device=device)
        lg, cache, _ = tfm.forward_seq(tree, cfg, prompt.to(device),
                                       cache=cache)
        logits, toks = [lg[:, -1].cpu()], []
        nxt = lg[:, -1].argmax(-1)
        for _ in range(steps):
            toks.append(nxt.cpu())
            lg1, cache, _ = tfm.decode_step(tree, cfg, cache, nxt[:, None])
            logits.append(lg1.cpu())
            nxt = lg1.argmax(-1)
        return torch.stack(logits, 1), torch.stack(toks, 1)

    linear_attention.launches = 0
    lg, toks = run(params, dev)
    if linear_attention.launches != cfg.num_layers:
        raise AssertionError(f"{arch} prefill launched the chunked kernel "
                             f"{linear_attention.launches} times, not once "
                             f"per layer")
    cpu_params = _tree_to(params, "cpu")
    del params
    free_memory()
    ref, ref_toks = run(cpu_params, torch.device("cpu"))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"non-finite {arch} logits")
    err = check_close(f"{arch} 4-layer logits card vs CPU, prefill and "
                      f"{steps} decode steps", lg, ref, 1e-3)
    if not torch.equal(toks, ref_toks):
        raise AssertionError(f"{arch} greedy tokens differ between the card "
                             f"and the CPU")
    log(f"  {arch} greedy tokens equal the CPU's over {steps} steps "
        f"(positions 32..{32 + steps - 1}, {width}-position cache)")
    return err


def phase_moe_parity(dev, steps: int = 16) -> dict:
    """Full-width ``olmoe_1b_7b`` cut to 4 layers, f32, TF32 off, at the
    published capacity factor 1.25: a prefill of 4 x 64 tokens (one MoE
    dispatch of 256 tokens, capacity 40 a group) into a paged cache, then
    ``steps`` greedy decode steps routed row by row, as the engine routes
    them. The card's logits agree with the CPU's at 1e-3, the greedy tokens
    and the prefill's dropped token-slots are equal, and some slot was
    dropped (the capacity bound was exercised)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = get_config("olmoe_1b_7b").replace(num_layers=4, dtype="float32")
    params = tfm.init_params(cfg, SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 64)))
    width = 128

    def run(tree, device):
        cache = tfm.init_cache(cfg, 4, width, device=device)
        lg, cache, aux = tfm.forward_seq(tree, cfg, prompt.to(device),
                                         cache=cache)
        logits, toks = [lg[:, -1].cpu()], []
        nxt = lg[:, -1].argmax(-1)
        for _ in range(steps):
            toks.append(nxt.cpu())
            lg1, cache, _ = tfm.decode_step(tree, cfg, cache, nxt[:, None])
            logits.append(lg1.cpu())
            nxt = lg1.argmax(-1)
        return (torch.stack(logits, 1), torch.stack(toks, 1),
                int(aux["dropped_slots"]))

    lg, toks, dropped = run(params, dev)
    cpu_params = _tree_to(params, "cpu")
    del params
    free_memory()
    ref, ref_toks, ref_dropped = run(cpu_params, torch.device("cpu"))
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("non-finite olmoe_1b_7b logits")
    err = check_close(f"olmoe_1b_7b 4-layer logits card vs CPU, prefill and "
                      f"{steps} decode steps", lg, ref, 1e-3)
    if not torch.equal(toks, ref_toks):
        raise AssertionError("olmoe_1b_7b greedy tokens differ between the "
                             "card and the CPU")
    log(f"  olmoe_1b_7b greedy tokens equal the CPU's over {steps} steps; "
        f"capacity dropped {dropped} of {4 * 4 * 64 * 8} token-slots in "
        f"the prefill (CPU {ref_dropped})")
    if dropped == 0 or dropped != ref_dropped:
        raise AssertionError(f"olmoe_1b_7b dropped slots: card {dropped}, "
                             f"CPU {ref_dropped} (must be equal, above 0)")
    return {"logits_max_abs_err": err, "dropped_slots": dropped}


def phase_paged_smoke(dev, arch: str = "nemotron_4_15b") -> None:
    """A config beyond llama at its f32 smoke width on the paged kernels
    (nemotron_4_15b: squared ReLU, layernorm; moonshot_v1_16b_a3b: MoE
    with a shared expert; qwen2_vl_72b: M-RoPE): a 12-request burst's
    greedy tokens on the card equal the same engine's on the CPU (plain
    versions)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.scheduler.policies import fcfs
    from repro_torch.kernels.flash_decode.ops import paged_decode_attention
    from repro_torch.kernels.flash_prefill.ops import flash_attention
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = tfm.init_params(cfg, SEED, device=dev)
    out, counts = {}, {}
    for where, tree in (("card", params), ("cpu", _tree_to(params, "cpu"))):
        device = tree["embed"].device
        for k in (paged_decode_attention, flash_attention):
            k.launches = 0
        eng = make_engine(cfg, tree, fcfs(), device, chunk=None,
                          caching=False, kv_blocks=64, cache_len=256)
        eng.submit(burst(12))
        fin = eng.run()
        if len(fin) != 12 or not eng.backend.paged:
            raise AssertionError(f"{arch} smoke on the {where}: "
                                 f"{len(fin)} of 12 finished")
        out[where] = {r.req_id: r.generated_tokens for r in fin}
        counts[where] = {k.__name__: k.launches for k in
                         (paged_decode_attention, flash_attention)}
        pads = eng.backend.prefill_pad_lanes
    if not all(counts["card"].values()):
        raise AssertionError(f"{arch} smoke: a kernel was never launched "
                             f"on the card: {counts['card']}")
    if out["card"] != out["cpu"]:
        diff = [i for i in out["cpu"] if out["cpu"][i] != out["card"][i]]
        raise AssertionError(f"{arch} smoke tokens differ for {diff}")
    log(f"  {arch} smoke (f32, paged): 12 requests' greedy tokens equal the "
        f"CPU's; card launches {counts['card']}; MoE padding lanes {pads}")


def serve_once(cfg, params, policy, dev, reqs, arch):
    from repro_torch.serving.metrics import RunCounters, report

    eng = make_engine(cfg, params, policy, dev, **SERVED[arch])
    eng.warmup()                        # a paged pool's decode graphs
    eng.submit(reqs)
    t0 = time.perf_counter()
    fin = eng.run()
    wall = time.perf_counter() - t0
    rep = report(policy.name, fin, counters=RunCounters.from_core(eng.core))
    return eng, fin, rep, wall


def phase_serve(dev, arch: str, kernels, idle=(),
                launcher_policy: str = "pars", depth=None,
                policies=("pars", "fcfs")) -> dict:
    """Serve full ``arch`` in bf16 (cut to ``depth`` layers where given)
    under each of ``policies``, then run the launcher under
    ``launcher_policy`` (``pars`` trains its full-width predictor first);
    a cut config's launcher must refuse ``--full``, saying that it does not
    fit. Every kernel of ``kernels`` must launch in each burst, and none of
    ``idle`` (kernels of other paths). Returns the PARS run's launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.pars_bert_base import CONFIG as PRED_CONFIG
    from repro_torch.core.predictor.train import RankingPredictor
    from repro_torch.core.scheduler.policies import fcfs, make_policy
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.replace(num_layers=depth)
    caching = SERVED[arch]["caching"]
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, SEED, device=dev)
    predictor = RankingPredictor.init(PRED_CONFIG, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {arch}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
        f"params bf16; predictor pars_bert_base "
        f"({sum(t.numel() for t in _leaves(predictor.params)) / 1e6:.1f} M "
        f"params); init {time.perf_counter() - t0:.1f} s")
    # warm the CUDA libraries once, outside the measured runs
    serve_once(cfg, params, fcfs(), dev, burst(2, seed=99), arch)

    launches = {}
    for name in policies:
        policy = (make_policy("pars", predictor) if name == "pars"
                  else fcfs())
        reqs = burst(16)
        for k in (*kernels, *idle):
            k.launches = 0
        eng, fin, rep, wall = serve_once(cfg, params, policy, dev, reqs, arch)
        counts = {k.__name__: k.launches for k in kernels}
        strays = {k.__name__: k.launches for k in idle if k.launches}
        tokens = sum(r.true_length for r in fin)
        log(f"  {rep.row()}")
        log(f"  {name}: {len(fin)} finished, {tokens} tokens in {wall:.2f} s "
            f"({tokens / wall:.1f} tok/s); launches {counts}; prefill "
            f"{eng.backend.prefill_dispatches} + extend "
            f"{eng.backend.extend_dispatches} dispatches (MoE padding lanes "
            f"{eng.backend.prefill_pad_lanes} in first chunks, "
            f"{eng.backend.prefill_graph_dispatches} of them graph replays; "
            f"continuation chunks and decode unpadded); prefix hits "
            f"{eng.backend.prefix_installs}, tokens copied "
            f"{eng.backend.prefix_tokens_copied}; decode "
            f"{eng.backend.decode_steps} steps in "
            f"{eng.backend.decode_seconds:.2f} s, "
            f"{eng.backend.decode_graph_steps} of them graph replays "
            f"padded by {eng.backend.decode_pad_rows} rows (capture "
            f"{eng.backend.capture_seconds:.2f} s, first chunks' "
            f"{eng.backend.prefill_capture_seconds:.2f} s of it); MoE "
            f"dropped slots "
            f"{eng.backend.dropped_slots}, expert rows "
            f"{eng.backend.expert_rows} for {eng.backend.routed_slots} "
            f"routed slots; scorer failures "
            f"{policy.scorer_failures}, degradations {policy.degradations}")
        problems = []
        if len(fin) != len(reqs):
            problems.append(f"{len(fin)} of {len(reqs)} finished")
        if any(v == 0 for v in counts.values()):
            problems.append(f"a kernel was never launched: {counts}")
        if strays:
            problems.append(f"another path's kernel launched: {strays}")
        if caching and eng.backend.prefix_installs == 0:
            problems.append("no prefix-cache hit")
        if eng.backend.prefix_tokens_copied != 0:
            problems.append("prefix hits copied KV")
        if eng.allocator.used_blocks != 0:
            problems.append(f"{eng.allocator.used_blocks} blocks held")
        if policy.scorer_failures or policy.degradations:
            problems.append("the predictor failed: PARS degraded to FCFS")
        if (dev.type == "cuda" and cfg.family == "moe"
                and eng.backend.prefill_graph_dispatches
                != eng.backend.prefill_dispatches):
            problems.append("a first chunk was not replayed")
        if name == "pars" and not all(r.scored for r in fin):
            problems.append("a request was never scored")
        for r in fin:
            if (len(r.generated_tokens) != r.true_length or not all(
                    0 <= t < cfg.vocab_size for t in r.generated_tokens)):
                problems.append(f"request {r.req_id}: bad tokens")
        if problems:
            raise AssertionError(f"serving {arch} under {name}: {problems}")
        launches[name] = counts
    del params, predictor, eng, fin
    free_memory()

    # the command-line entry point, at published widths on the card
    argv = ["--arch", arch, "--full", "--policy", launcher_policy,
            "--requests", "8", "--batch", "4", "--max-len", "16"]
    if depth is not None:
        try:
            launch_serve.main(argv)
        except SystemExit as e:
            if "does not fit" not in str(e):
                raise
            log(f"  launcher --full: {e}")
        else:
            raise AssertionError(f"the launcher served {arch} --full, "
                                 f"which does not fit the card")
        return launches["pars"]
    rep = launch_serve.main(argv)
    if rep.n_requests != 8:
        raise AssertionError(f"launcher served {rep.n_requests} of 8")
    free_memory()
    return launches["pars"]


def phase_mla_serve(dev, idle, arch="moonlight_16b_a3b") -> dict:
    """Full ``moonlight_16b_a3b`` (27 layers of MLA, layer 0 dense, 26 of
    sigmoid-routed experts beside shared ones; bf16, 15.96 B), or
    ``kimi_k2_instruct`` (one H100's share of Kimi K2: 11 layers of
    64-head MLA with a query path and YaRN, 48 of 384 experts held; bf16,
    23.41 B, drawn by the benchmark's ``mla_ep`` in bf16, as
    ``init_params``'s f32 draws would not fit beside them), behind a
    ``pars_bert_base``-width predictor, in the benchmark cell's engine (64
    slots, 2,048 positions, 8,192 blocks of 16) with chunks of 64 and
    prefix caching, its decode graphs captured: a 16-request burst under
    PARS in two waves of 8 (the second's system prompts hit the first's
    cached blocks), every launch count set to 0 after the captures and
    read after the run. The latent decode kernel must launch exactly once a layer a
    decode step (every step a replay), the prefill kernel's exactly once a
    layer a prefill or extend dispatch, ``slot_positions`` exactly once a
    MoE layer a dispatch of either kind, and no kernel of ``idle``. Then
    each bucket's replayed step and the eager step, rows at position 160 on
    blocks of their own, timed with CUDA events; a share of the experts
    prints ``held_slots / routed_slots``. Returns the run's launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.configs.latent import dense_layers
    from repro_torch.configs.pars_bert_base import CONFIG as PRED_CONFIG
    from repro_torch.core.predictor.train import RankingPredictor
    from repro_torch.core.scheduler.policies import make_policy
    from repro_torch.kernels.flash_decode.ops import latent_decode_attention
    from repro_torch.kernels.flash_prefill.ops import flash_attention
    from repro_torch.kernels.moe_route.ops import slot_positions
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    t0 = time.perf_counter()
    if getattr(cfg, "experts_held", 0):
        from bench.harness import spec
        params = spec.arch("mla_ep").make_params(cfg, SEED, dev)
    else:
        params = tfm.init_params(cfg, SEED, device=dev)
    predictor = RankingPredictor.init(PRED_CONFIG, SEED, device=dev)
    policy = make_policy("pars", predictor)
    eng = make_engine(cfg, params, policy, dev, max_batch=64, **SERVED[arch])
    eng.warmup()
    torch.cuda.synchronize()
    be = eng.backend

    def graphs(shapes):
        return sum(step.graph is not None for step in shapes.values())
    log(f"  {arch}: {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params bf16, "
        f"latent pool {tuple(be.k_pool.shape)}; init and captures "
        f"{time.perf_counter() - t0:.1f} s (captures "
        f"{be.capture_seconds:.2f} s: {graphs(be._first_shapes)} first-chunk "
        f"graphs {be.prefill_capture_seconds:.2f} s, "
        f"{graphs(be._decode_shapes)} decode graphs the rest)")
    kernels = (latent_decode_attention, flash_attention, slot_positions)
    for k in (*kernels, *idle):
        k.launches = 0
    # two waves of 8: the second's system prompts hit the first's blocks
    reqs = burst(16)
    t0 = time.perf_counter()
    for wave in (reqs[:8], reqs[8:]):
        eng.submit(wave)
        fin = eng.run()                 # every request finished so far
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in (*kernels, *idle)}
    layers = cfg.num_layers
    dispatches = be.prefill_dispatches + be.extend_dispatches
    want = {k.__name__: 0 for k in idle}
    want.update({latent_decode_attention.__name__: layers * be.decode_steps,
                 flash_attention.__name__: layers * dispatches,
                 slot_positions.__name__: (layers - dense_layers(cfg))
                 * (be.decode_steps + dispatches)})
    tokens = sum(r.true_length for r in fin)
    log(f"  pars: {len(fin)} finished, {tokens} tokens in {wall:.2f} s; "
        f"launches {counts}; prefill {be.prefill_dispatches} + extend "
        f"{be.extend_dispatches} dispatches, {be.prefill_graph_dispatches} "
        f"of the first graph replays; prefix hits "
        f"{be.prefix_installs}; latent rows expanded "
        f"{be.latent_rows_expanded}; decode {be.decode_steps} steps, "
        f"{be.decode_graph_steps} of them replays padded by "
        f"{be.decode_pad_rows} rows; MoE dropped slots {be.dropped_slots}, "
        f"expert rows {be.expert_rows} for {be.routed_slots} routed slots, "
        f"held_slots / routed_slots {be.held_slots} / {be.routed_slots} = "
        f"{be.held_slots / max(be.routed_slots, 1):.4f}")
    problems = []
    if counts != want:
        problems.append(f"launches {counts}, expected {want}")
    if len(fin) != len(reqs):
        problems.append(f"{len(fin)} of {len(reqs)} finished")
    if dev.type == "cuda" and be.decode_graph_steps != be.decode_steps:
        problems.append(f"{be.decode_steps - be.decode_graph_steps} decode "
                        f"steps were not replayed")
    if dev.type == "cuda" and \
            be.prefill_graph_dispatches != be.prefill_dispatches:
        problems.append(f"{be.prefill_dispatches - be.prefill_graph_dispatches}"
                        f" first chunks were not replayed")
    if be.extend_dispatches == 0 or be.prefix_installs == 0:
        problems.append("no continuation chunk or no prefix-cache hit")
    if eng.allocator.used_blocks != 0:
        problems.append(f"{eng.allocator.used_blocks} blocks held")
    if policy.scorer_failures or policy.degradations:
        problems.append("the predictor failed: PARS degraded to FCFS")
    for r in fin:
        if (len(r.generated_tokens) != r.true_length or not all(
                0 <= t < cfg.vocab_size for t in r.generated_tokens)):
            problems.append(f"request {r.req_id}: bad tokens")
    if problems:
        raise AssertionError(f"serving {arch}: {problems}")

    if dev.type == "cuda":
        time_steps(be, cfg, first=((1, 64),))
    del params, predictor, eng, fin, be
    free_memory()
    return {k: v for k, v in counts.items() if v}


def time_steps(be, cfg, buckets=(1, 8, 16, 32, 56, 64), position=160,
               first=((1, 512), (8, 64), (1, 8))) -> dict:
    """A warmed MoE backend's captured steps timed with CUDA events: each
    decode bucket of ``buckets``, rows at ``position`` on blocks of their
    own, replayed and eager, with the expert rows and routed slots that a
    step adds to ``expert_rows`` and ``routed_slots`` (their ratio the
    expert rows' use); then the replay of each first-chunk shape of
    ``first`` on the grid, every lane on blocks of its own and every token
    real."""
    from repro_torch.configs.latent import dense_layers, experts_held
    from repro_torch.models.moe import expert_rows, groups_of

    moe = cfg.moe
    layers = cfg.num_layers - dense_layers(cfg)
    per = -(-(position + 1) // 16)
    out = {"decode": [], "first": []}
    for b in buckets:
        step = be._decode_shapes[b]
        if step.graph is None:
            raise AssertionError(f"decode bucket {b} holds no graph")
        step.stage([list(range(j * per, (j + 1) * per))
                    + [be._null_block] * (step.nb - per)
                    for j in range(b)], [[position] * b])
        rows = layers * expert_rows(*groups_of(b, 1, moe, True), moe,
                                    experts_held(cfg))
        slots = layers * moe.top_k * b
        out["decode"].append({
            "rows": b, "position": position,
            "replay_ms": cuda_ms(step.run, iters=10),
            "eager_ms": cuda_ms(lambda: step.forward(step), iters=3,
                                warmup=1),
            "expert_rows": rows, "routed_slots": slots})
        log(f"  decode step, {b} rows at position {position}: replay "
            f"{out['decode'][-1]['replay_ms']:.2f} ms, eager "
            f"{out['decode'][-1]['eager_ms']:.2f} ms; expert rows {rows} "
            f"for {slots} routed slots (use {slots / rows:.4f})")
    gen = torch.Generator(device=be.device).manual_seed(SEED)
    for lanes, width in first:
        step = be._first_shapes.get((lanes, width))
        if step is None or step.graph is None:
            raise AssertionError(f"first-chunk shape {(lanes, width)} holds "
                                 f"no graph")
        tokens = torch.randint(1, cfg.vocab_size, (lanes, width),
                               generator=gen, device=be.device)
        step.stage([list(range(j * step.nb, (j + 1) * step.nb))
                    for j in range(lanes)],
                   [[width] * lanes, list(range(lanes))],
                   tokens.cpu().numpy())
        out["first"].append({"lanes": lanes, "tokens": width,
                             "replay_ms": cuda_ms(step.run, iters=10)})
        log(f"  first chunk, {lanes} x {width} tokens: replay "
            f"{out['first'][-1]['replay_ms']:.2f} ms")
    return out


def phase_moe_steps(dev) -> dict:
    """Full ``olmoe_1b_7b`` (16 layers, 64 experts, bf16) in the benchmark
    cell's engine (64 slots, prompts of up to 1,024 tokens, 2,048
    positions, 8,192 blocks of 16, chunks of 512, prefix caching), its
    decode buckets and first-chunk shapes captured: each step timed by
    :func:`time_steps`."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler.policies import fcfs
    from repro_torch.models import transformer as tfm

    cfg = get_config("olmoe_1b_7b")
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, SEED, device=dev)
    eng = make_engine(cfg, params, fcfs(), dev, chunk=512, caching=True,
                      kv_blocks=8192, cache_len=2048, max_batch=64,
                      prompt_len=1024)
    eng.warmup()
    torch.cuda.synchronize()
    be = eng.backend
    log(f"  olmoe_1b_7b: init and captures {time.perf_counter() - t0:.1f} s "
        f"(captures {be.capture_seconds:.2f} s, first chunks' "
        f"{be.prefill_capture_seconds:.2f} s of it)")
    out = time_steps(be, cfg)
    del params, eng, be
    free_memory()
    return out


# ---------------------------------------------------------------------------
# Phases 6 to 8: training
# ---------------------------------------------------------------------------
EPOCH_LINE = re.compile(r"epoch (\d+): loss ([-\d.naif]+) \((\d+) steps, "
                        r"([\d.]+) ms/step\)")


def _epochs(lines) -> list:
    """``[{"epoch", "loss", "steps", "ms_per_step"}]`` from the training
    log lines of ``train_predictor``; fails on a non-finite loss."""
    out = []
    for line in lines:
        m = EPOCH_LINE.search(line)
        if m is None:
            raise AssertionError(f"unexpected training log line: {line!r}")
        rec = {"epoch": int(m[1]), "loss": float(m[2]), "steps": int(m[3]),
               "ms_per_step": float(m[4])}
        if not np.isfinite(rec["loss"]) or rec["steps"] == 0:
            raise AssertionError(f"predictor training failed: {line!r}")
        out.append(rec)
    return out


def phase_train_predictor(dev):
    """The mini predictor to the reference's bar (``tests/test_system.py``:
    800 alpaca prompts, gpt4 lengths, pairwise, 2 epochs of 2560 pairs,
    held-out tau_b >= 0.45 on 300 prompts), one epoch each of the pointwise
    and listwise baselines, then the launcher's full-width pars_bert_base
    predictor, its held-out tau after each epoch from runs of 1 and 2
    epochs (the same batches from the same seed). Returns (the full
    predictor, the numbers)."""
    from repro_torch.core.predictor import (TrainSettings, evaluate_tau,
                                            train_predictor)
    from repro_torch.data.synthetic import make_corpus, sample_lengths
    from repro_torch.launch import serve as launch_serve

    c_train = make_corpus("alpaca", 800, seed=0)
    c_test = make_corpus("alpaca", 300, seed=42)
    l_train = sample_lengths(c_train, "gpt4")
    l_test = sample_lengths(c_test, "gpt4", run_seed=9)
    mini = {}
    for method, epochs in (("pairwise", 2), ("pointwise", 1),
                           ("listwise", 1)):
        lines = []
        st = TrainSettings(method=method, epochs=epochs, pairs_per_epoch=2560,
                           delta=0.2)
        pred = train_predictor(c_train.prompts, l_train, settings=st,
                               log_fn=lines.append, device=dev)
        tau = evaluate_tau(pred, c_test.prompts, l_test)
        mini[method] = {"tau": tau, "epochs": _epochs(lines)}
        log(f"  mini {method}: {lines}; held-out tau_b {tau:.4f}")
    if not mini["pairwise"]["tau"] >= 0.45:
        raise AssertionError(f"mini pairwise predictor tau_b "
                             f"{mini['pairwise']['tau']:.4f} < 0.45")

    max_len = 120                       # the serve launcher's --max-len
    l_test = np.clip(sample_lengths(c_test, "llama", run_seed=9), 1, max_len)
    taus = []
    for epochs in (1, 2):
        lines = []
        t0 = time.perf_counter()
        pred = launch_serve.train_ranker("pars", "llama", max_len, full=True,
                                         device=dev, epochs=epochs,
                                         log_fn=lines.append)
        wall = time.perf_counter() - t0
        tau = evaluate_tau(pred, c_test.prompts, l_test)
        log(f"  pars_bert_base, {epochs} epoch(s) in {wall:.1f} s: {lines}; "
            f"held-out tau_b {tau:.4f}")
        taus.append(tau)
    per_epoch = _epochs(lines)
    for rec, tau in zip(per_epoch, taus):
        rec["tau"] = tau
    full = {"params": sum(t.numel() for t in _leaves(pred.params)),
            "epochs": per_epoch}
    return pred, {"mini": mini, "pars_bert_base": full}


def predictor_determinism(device: str = "cuda") -> dict:
    """Three pairwise steps of the serve launcher's ``pars_bert_base``
    predictor (its corpus, lengths and settings, 384 pairs), once with
    PyTorch's default kernels and twice under
    ``torch.use_deterministic_algorithms``, from one seed. Returns each
    run's epoch line and a SHA-256 digest of its final parameters. Runs in
    a process of its own (:func:`phase_predictor_determinism`)."""
    import hashlib
    import warnings

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import pars_bert_base
    from repro_torch.core.predictor import TrainSettings, train_predictor
    from repro_torch.core.predictor.tokenizer import HashTokenizer
    from repro_torch.data.synthetic import (MODELS, make_corpus,
                                            sample_lengths)

    corpus = make_corpus("alpaca", 1000, seed=1)
    lengths = np.clip(sample_lengths(corpus, "llama"), 1, 120)
    pcfg = pars_bert_base.CONFIG
    settings = TrainSettings(method="pairwise", epochs=1,
                             pairs_per_epoch=3 * 128,
                             delta=MODELS["llama"].delta)
    out = {}
    for mode, runs in (("default", 1), ("deterministic", 2)):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        for run in range(runs):
            lines = []
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                pred = train_predictor(
                    corpus.prompts, lengths, settings=settings,
                    tokenizer=HashTokenizer(vocab_size=pcfg.vocab_size,
                                            max_len=pcfg.max_len),
                    pcfg=pcfg, log_fn=lines.append, device=device)
            digest = hashlib.sha256()
            for leaf in _leaves(pred.params):
                digest.update(leaf.detach().cpu().numpy().tobytes())
            out[f"{mode}_{run}"] = {
                "epoch_line": lines[-1], "digest": digest.hexdigest(),
                "alerts": sorted({str(w.message)[:120] for w in caught
                                  if "determinis" in str(w.message)})}
    torch.use_deterministic_algorithms(False)
    return out


def phase_predictor_determinism() -> dict:
    """Runs :func:`predictor_determinism` in two processes with different
    hash salts (``PYTHONHASHSEED``), each with cuBLAS's deterministic
    workspace set before its first call. Fails if the deterministic runs
    end with different parameters, in one process or across the two."""
    runs = {}
    for salt in ("1", "2"):
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTHONHASHSEED=salt)
        proc = subprocess.run(
            [sys.executable, "-c", "import json, chip_smoke; print(json."
             "dumps(chip_smoke.predictor_determinism()))"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"determinism check failed:\n"
                                 f"{proc.stderr[-3000:]}")
        runs[salt] = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, rec in runs[salt].items():
            log(f"  pars_bert_base 3 steps, process {salt}, {name}: "
                f"{rec['epoch_line']}; params {rec['digest'][:16]}; alerts "
                f"{rec['alerts']}")
    digests = {(salt, name): rec["digest"] for salt, run in runs.items()
               for name, rec in run.items()}
    det = {d for (salt, name), d in digests.items()
           if name.startswith("deterministic")}
    out = {"deterministic_equal": len(det) == 1,
           "default_equals_deterministic": len(set(digests.values())) == 1,
           "runs": runs}
    log(f"  deterministic runs equal in and across processes: "
        f"{out['deterministic_equal']}; default kernels equal them too: "
        f"{out['default_equals_deterministic']}")
    if not out["deterministic_equal"]:
        raise AssertionError(f"pars_bert_base training differs between "
                             f"runs from one seed under deterministic "
                             f"algorithms: unseeded state ({digests})")
    return out


def phase_trained_pars(dev, predictor) -> dict:
    """A 32-request burst (alpaca seed 9, llama lengths clipped to 1..64) on
    full llama3_2_3b with phase 4's paged engine, under FCFS, PARS with the
    phase-6 predictor and oracle SJF. Checks are deterministic only; the
    latencies are logged."""
    from repro_torch.configs import get_config
    from repro_torch.core.predictor import kendall_tau_b
    from repro_torch.core.scheduler.policies import (fcfs, make_policy,
                                                     oracle_sjf)
    from repro_torch.data.synthetic import make_corpus, sample_lengths
    from repro_torch.data.workload import burst_arrivals, make_requests
    from repro_torch.models import transformer as tfm

    arch = "llama3_2_3b"
    cfg = get_config(arch)
    params = tfm.init_params(cfg, SEED, device=dev)
    corpus = make_corpus("alpaca", 32, seed=9)
    lengths = np.clip(sample_lengths(corpus, "llama"), 1, 64)
    tau = kendall_tau_b(predictor.score(corpus.prompts), lengths)
    log(f"  trained predictor's tau_b on the burst's lengths: {tau:.4f}")
    if not tau > 0:
        raise AssertionError(f"trained predictor tau_b {tau:.4f} <= 0 on "
                             f"the burst")
    serve_once(cfg, params, fcfs(), dev, burst(2, seed=99), arch)   # warm
    out = {"burst_tau": tau}
    for name, policy in (("fcfs", fcfs()),
                         ("pars", make_policy("pars", predictor)),
                         ("oracle_sjf", oracle_sjf())):
        reqs = make_requests(corpus, lengths, burst_arrivals(32))
        _, fin, rep, wall = serve_once(cfg, params, policy, dev, reqs, arch)
        log(f"  {rep.row()} (wall {wall:.2f} s)")
        if len(fin) != 32 or any(len(r.generated_tokens) != r.true_length
                                 for r in fin):
            raise AssertionError(f"trained-PARS burst under {name}: "
                                 f"{len(fin)} of 32 finished whole")
        if policy.scorer_failures or policy.degradations:
            raise AssertionError(f"{name}: the predictor failed")
        out[name] = {"avg_per_token_s": rep.avg_per_token_latency,
                     "p90_per_token_s": rep.p90_per_token_latency,
                     "ttft_s": rep.avg_ttft, "wall_s": wall}
    del params
    free_memory()
    return out


def phase_train_lm(dev) -> dict:
    """Full-width llama3_2_3b cut to 4 layers, f32, TF32 off: the training
    forward (chunked attention) against the kernel path's logits at 1e-3,
    and one train step's loss and grad norm on the card against the CPU at
    1e-3 relative. Then the full model in bf16 with remat: ten steps of the
    launcher's optimizer on one repeated batch of 4 x 64 (the loss must
    fall, every grad norm be finite), and the launcher itself for two."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import example_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.training import Adam, cosine_schedule
    from repro_torch.training.train_loop import make_train_step

    def optimizer(steps):                # launch/train.py's
        return Adam(learning_rate=cosine_schedule(3e-4, 5, steps),
                    clip_norm=1.0)

    cfg = get_config("llama3_2_3b").replace(num_layers=4, dtype="float32")
    params = tfm.init_params(cfg, SEED, device=dev)
    batch = example_batch(cfg, 2, 32, 1, device=dev)
    with torch.no_grad():
        train_logits, _, _ = tfm.forward_seq(params, cfg, batch["tokens"],
                                             attn_impl="chunked")
        kernel_logits, _, _ = tfm.forward_seq(params, cfg, batch["tokens"])
    err = check_close("4-layer f32 training forward (chunked attention) vs "
                      "kernel path", train_logits, kernel_logits, 1e-3)
    del train_logits, kernel_logits
    metrics = {}
    cpu = torch.device("cpu")
    copies = {"card": params, "cpu": _tree_to(params, cpu)}  # before a step
    for where, device in (("card", dev), ("cpu", cpu)):
        p = copies.pop(where)
        b = {k: v.to(device) for k, v in batch.items()}
        opt = optimizer(10)
        t0 = time.perf_counter()
        _, _, m = make_train_step(cfg, opt, remat="full")(p, opt.init(p), b)
        metrics[where] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        log(f"  4-layer f32 train step on the {where}: {metrics[where]} in "
            f"{time.perf_counter() - t0:.1f} s")
        del p
    for k in ("loss", "grad_norm"):
        a, b = metrics["card"][k], metrics["cpu"][k]
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"train step {k}: card {a} vs CPU {b}")
    del params
    free_memory()

    cfg = get_config("llama3_2_3b")
    steps, b, s = 10, 4, 64
    params = tfm.init_params(cfg, SEED, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    opt = optimizer(steps)
    state = opt.init(params)
    step = make_train_step(cfg, opt, remat="full")
    batch = example_batch(cfg, b, s, 1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))          # waits for the step
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    ms = 1e3 * float(np.mean(secs[1:]))
    tokens_s = b * s / (ms / 1e3)
    share = 6 * n_params * b * s / (ms / 1e3) / BF16_FLOPS_S
    log(f"  full llama3_2_3b bf16 remat=full, batch {b} x {s}: losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in norms]}; {ms:.1f} ms/step after the first "
        f"({1e3 * secs[0]:.1f} ms), {tokens_s:.0f} tokens/s, peak "
        f"{peak / 1e9:.2f} GB, {share:.4f} of the bf16 peak (6 N tokens)")
    if not all(np.isfinite(norms)) or not losses[-1] < losses[0]:
        raise AssertionError(f"full-width training: losses {losses}, grad "
                             f"norms {norms}")
    # where a step's time goes: one more step under the profiler (after the
    # timed ones), device time by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(device_rows(prof), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profiled step: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall")
    for t, count, key in rows[:12]:
        log(f"    {t:9.2f} ms {t / max(busy, 1e-9):6.1%} {count:6d} calls  "
            f"{key[:90]}")
    # and the host's side of one more step: operators and CUDA runtime
    # calls (traced with the device activity) by their own host time
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, m = step(params, state, batch)
        float(m["loss"])
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    log("  profiled step, host time by operator or runtime call:")
    for t, count, key in host[:10]:
        log(f"    {t:9.2f} ms {count:6d} calls  {key[:90]}")
    del params, state
    free_memory()
    _, history = launch_train.main(["--full", "--steps", "2", "--batch", "2",
                                    "--seq", "32", "--device", str(dev)])
    if not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"train launcher: {history}")
    free_memory()
    return {"f32_4_layers": {"logits_max_abs_err": err, **{
                f"{k}_{d}": v for d, m in metrics.items()
                for k, v in m.items()}},
            "llama3_2_3b_bf16": {
                "params": n_params, "layers": cfg.num_layers, "batch": b,
                "seq": s, "losses": losses,
                "grad_norms": norms, "first_step_ms": 1e3 * secs[0],
                "ms_per_step": ms, "tokens_per_s": tokens_s,
                "peak_memory_bytes": peak, "bf16_peak_share": share,
                "profiled_step": {
                    "wall_ms": wall_ms, "device_busy_ms": busy,
                    "top": [{"ms": t, "calls": c, "kernel": k[:90]}
                            for t, c, k in rows[:8]],
                    "host_top": [{"ms": t, "calls": c, "op": k[:90]}
                                 for t, c, k in host[:6]]}}}


def phase_whisper(dev, kernels) -> dict:
    """Whisper at its published widths (``whisper_tiny``: 4 encoder and 4
    decoder layers, d 384, 6 heads of 64, vocab 51,865, 1,500 frames; no
    cut) through ``build(cfg)``, the reference's inference path (its engine
    cannot serve the family). f32, TF32 off: the card's logits of
    ``prefill`` and 8 greedy ``decode_step``s against the CPU's at 1e-3,
    the greedy tokens equal, and every step's logits equal to the card's
    full forward over the whole sequence at that position (atol 2e-4,
    rtol 2e-3: the reference's ``test_arch_smoke``). Then bf16: 4 requests
    of 64-token prompts, 32 greedy tokens (the prefill's and 31 decode
    steps'), every launch count set to 0 just before and read just after:
    the prefill kernel exactly 12 times (4 encoder, 4 self, 4 cross), ring
    decode exactly 8 times a decode step (4 self, 4 cross), no other
    kernel. ``kernels`` are the four wrappers."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode.ops import ring_decode_attention
    from repro_torch.kernels.flash_prefill.ops import flash_attention
    from repro_torch.models import build
    from repro_torch.models import transformer as tfm

    cfg = get_config("whisper_tiny").replace(dtype="float32")
    bundle = build(cfg)
    params = bundle.init(SEED, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    b, s, steps = 2, 24, 8
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    frames = torch.randn(b, cfg.encoder_seq_len, cfg.d_model,
                         generator=gen) * 0.02

    def run(tree, device):
        lg, cache = bundle.prefill(tree, prompt.to(device), s + steps,
                                   frames=frames.to(device))
        logits, toks = [lg[:, -1].cpu()], []
        nxt = lg[:, -1].argmax(-1)
        for _ in range(steps):
            toks.append(nxt.cpu())
            lg1, cache = bundle.decode_step(tree, cache, nxt[:, None])
            logits.append(lg1.cpu())
            nxt = lg1.argmax(-1)
        return torch.stack(logits, 1), torch.stack(toks, 1)

    lg, toks = run(params, dev)
    full, _, _ = tfm.forward_seq(params, cfg,
                                 torch.cat([prompt, toks], 1).to(dev),
                                 frames=frames.to(dev))
    full = full[:, s - 1:].cpu()
    torch.testing.assert_close(lg, full, atol=2e-4, rtol=2e-3)
    log(f"  whisper_tiny f32: prefill + {steps} decode steps' logits equal "
        f"the full forward's (max_abs_err "
        f"{(lg - full).abs().max().item():.3e}, atol 2e-4, rtol 2e-3)")
    ref, ref_toks = run(_tree_to(params, "cpu"), torch.device("cpu"))
    err = check_close(f"whisper_tiny f32 logits card vs CPU, prefill and "
                      f"{steps} decode steps", lg, ref, 1e-3)
    if not torch.equal(toks, ref_toks):
        raise AssertionError("whisper_tiny greedy tokens differ between the "
                             "card and the CPU")
    log(f"  whisper_tiny greedy tokens equal the CPU's over {steps} steps")
    del params
    free_memory()

    cfg = get_config("whisper_tiny")
    bundle = build(cfg)
    params = bundle.init(SEED, device=dev)
    b, s, n_tok = 4, 64, 32
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    frames = (torch.randn(b, cfg.encoder_seq_len, cfg.d_model, generator=gen,
                          device=dev) * 0.02).to(torch.bfloat16)
    with torch.no_grad():          # a warm-up request, not counted
        bundle.prefill(params, prompt[:1], s + n_tok, frames=frames[:1])
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    lg, cache = bundle.prefill(params, prompt, s + n_tok, frames=frames)
    nxt = lg[:, -1].argmax(-1)
    out = [nxt]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n_tok - 1):
        lg1, cache = bundle.decode_step(params, cache, nxt[:, None])
        nxt = lg1.argmax(-1)
        out.append(nxt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    want = {k.__name__: 0 for k in kernels}
    want[flash_attention.__name__] = cfg.encoder_layers + 2 * cfg.num_layers
    want[ring_decode_attention.__name__] = 2 * cfg.num_layers * (n_tok - 1)
    if launches != want:
        raise AssertionError(f"whisper_tiny bf16 launches {launches}, "
                             f"expected {want}")
    if not bool(torch.isfinite(lg1).all()) or len(out) != n_tok:
        raise AssertionError("whisper_tiny bf16: non-finite logits")
    step_ms = 1e3 * (t2 - t1) / (n_tok - 1)
    log(f"  whisper_tiny bf16, {b} requests x {s}-token prompts, {n_tok} "
        f"greedy tokens: prefill {1e3 * (t1 - t0):.1f} ms, decode "
        f"{step_ms:.2f} ms a step ({step_ms / b:.3f} ms a token); launches "
        f"{launches} (exact)")
    del params, cache
    free_memory()
    return {"f32_logits_max_abs_err": err, "bf16": {
        "requests": b, "prompt": s, "tokens": n_tok,
        "prefill_ms": 1e3 * (t1 - t0), "decode_step_ms": step_ms,
        "ms_per_token": step_ms / b, "launches": launches}}


def _remat_memory(cfg, params, batch, remat) -> dict:
    """Device bytes above the parameters of one loss-and-gradient pass
    under ``remat``: the forward's peak (what the policy keeps for
    backward, plus one layer's temporaries) and the whole pass's peak."""
    from repro_torch.bridge import flatten, unflatten
    from repro_torch.models.model import lm_loss

    free_memory()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in flatten(params).items()}
    loss, _ = lm_loss(unflatten(leaves), cfg, batch, remat=remat)
    torch.cuda.synchronize()
    forward = torch.cuda.max_memory_allocated() - before
    grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    whole = torch.cuda.max_memory_allocated() - before
    del grads, loss, leaves
    return {"forward_peak": forward, "pass_peak": whole}


# rwkv6_7b trains cut to at most this many of its 32 layers, fewer where
# its bf16 weights, gradients, Adam's f32 moments and the update's
# temporaries (allowed 18 bytes a parameter) would not fit the card
TRAIN_DEPTH_CAP = 12


def phase_train_families(dev) -> dict:
    """The hybrid, SSM and encoder-decoder families train on the card, as
    phase 8 trains llama. f32, TF32 off, at full width (``hymba_1_5b`` and
    ``rwkv6_7b`` cut to 4 layers, ``whisper_tiny`` whole): the training
    forward (plain attention and linear-attention scan) within 1e-3 of the
    kernel route's logits, one train step's loss and grad norm on the card
    within 1e-3 relative of the same step on the CPU in f64
    (:func:`f64_upcasts`); the CPU's f32 step is run and logged beside it.
    At RWKV-6's full width the f32 step is conditioned at about 1e-3 (the
    per-head group norm amplifies rounding layer by layer), so an f32 CPU
    run is no reference at that tolerance: its grad norm was 1.29e-3 from
    the f64 step's, the card's 1.3e-4. Then bf16 with ``remat="full"``,
    ten steps of the launcher's optimizer on one repeated 4 x 64 batch:
    ``hymba_1_5b`` at its 32 layers, ``rwkv6_7b`` at the deepest depth up
    to 12 that fits (the cut is printed), ``whisper_tiny`` whole; the loss
    must fall and every grad norm be finite; ms a step, tokens/s, peak
    memory, and one profiled step's device time by kernel. Once, on
    ``hymba_1_5b`` over 4 x 512 tokens: the peak memory of one gradient
    pass's forward (what each policy keeps for backward) under remat
    ``none``, ``dots`` and ``full``, which must read none >= dots >= full,
    and of the whole pass."""
    from repro_torch.configs import get_config
    from repro_torch.models import example_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.training import Adam, cosine_schedule
    from repro_torch.training.train_loop import make_train_step

    def optimizer(steps):                # launch/train.py's
        return Adam(learning_rate=cosine_schedule(3e-4, 5, steps),
                    clip_norm=1.0)

    out = {}
    cpu = torch.device("cpu")
    for arch in ("hymba_1_5b", "rwkv6_7b", "whisper_tiny"):
        t_arch = time.perf_counter()
        cfg = get_config(arch).replace(dtype="float32")
        if not cfg.is_encdec:
            cfg = cfg.replace(num_layers=4)
        params = tfm.init_params(cfg, SEED, device=dev)
        batch = example_batch(cfg, 2, 32, 1, device=dev)
        extras = {"frames": batch["frames"]} if "frames" in batch else {}
        with torch.no_grad():
            train_logits, _, _ = tfm.forward_seq(
                params, cfg, batch["tokens"], attn_impl="chunked", **extras)
            kernel_logits, _, _ = tfm.forward_seq(params, cfg,
                                                  batch["tokens"], **extras)
        err = check_close(f"{arch} f32 training forward (plain route) vs "
                          f"kernel route", train_logits, kernel_logits, 1e-3)
        del train_logits, kernel_logits
        metrics = {}
        host = _tree_to(params, cpu)
        for where in ("card", "cpu", "cpu_f64"):
            f64 = where == "cpu_f64"
            with f64_upcasts() if f64 else contextlib.nullcontext():
                p = (params if where == "card" else _tree_to(host, cpu)
                     if not f64 else _tree_to(host, cpu, torch.float64))
                b = {k: v.to(dev if where == "card" else cpu)
                     for k, v in batch.items()}
                if f64:
                    b = {k: v.double() if v.is_floating_point() else v
                         for k, v in b.items()}
                opt = optimizer(10)
                t0 = time.perf_counter()
                _, _, m = make_train_step(cfg, opt, remat="none")(
                    p, opt.init(p), b)
                metrics[where] = {k: float(m[k])
                                  for k in ("loss", "grad_norm")}
            log(f"  {arch} f32 train step on the {where}: {metrics[where]} "
                f"in {time.perf_counter() - t0:.1f} s")
            del p, b, opt
            if where == "card":
                del params
                free_memory()
        del host
        truth = metrics["cpu_f64"]
        for k in ("loss", "grad_norm"):
            a, c = metrics["card"][k], truth[k]
            if not abs(a - c) <= 1e-3 * abs(c):
                raise AssertionError(f"{arch} train step {k}: card {a} vs "
                                     f"CPU (f64) {c}")
        log(f"  {arch} grad norm relative to the CPU's f64 step: card "
            f"{abs(metrics['card']['grad_norm'] / truth['grad_norm'] - 1):.2e}"
            f", CPU f32 "
            f"{abs(metrics['cpu']['grad_norm'] / truth['grad_norm'] - 1):.2e}")

        cfg = get_config(arch)
        cut = None
        if arch == "rwkv6_7b":
            have = torch.cuda.get_device_properties(dev).total_memory
            depth = next(n for n in range(min(TRAIN_DEPTH_CAP,
                                              cfg.num_layers), 0, -1)
                         if tfm.param_count(cfg.replace(num_layers=n)) * 18
                         < have)
            cut = f"{depth} of {cfg.num_layers} layers"
            cfg = cfg.replace(num_layers=depth)
        steps, b, s = 10, 4, 64
        params = tfm.init_params(cfg, SEED, device=dev)
        n_params = sum(t.numel() for t in _leaves(params))
        opt = optimizer(steps)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat="full")
        batch = example_batch(cfg, b, s, 1, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, secs = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))      # waits for the step
            norms.append(float(m["grad_norm"]))
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        ms = 1e3 * float(np.mean(secs[1:]))
        log(f"  {arch} bf16 remat=full ({cut or 'no cut'}; "
            f"{n_params / 1e9:.3f} B parameters), batch {b} x {s}: losses "
            f"{[round(x, 4) for x in losses]}, grad norms "
            f"{[round(x, 3) for x in norms]}; {ms:.1f} ms/step after the "
            f"first ({1e3 * secs[0]:.1f} ms), {b * s / (ms / 1e3):.0f} "
            f"tokens/s, peak {peak / 1e9:.2f} GB")
        if not all(np.isfinite(norms)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{arch} bf16 training: losses {losses}, "
                                 f"grad norms {norms}")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            float(m["loss"])
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = sorted(device_rows(prof), reverse=True)
        busy = sum(r[0] for r in rows)
        log(f"  {arch} profiled step: device busy {busy:.1f} ms of "
            f"{wall_ms:.1f} ms wall")
        for t, count, key in rows[:8]:
            log(f"    {t:9.2f} ms {t / max(busy, 1e-9):6.1%} {count:6d} calls"
                f"  {key[:90]}")
        out[arch] = {
            "f32": {"logits_max_abs_err": err, **{
                f"{k}_{d}": v for d, m in metrics.items()
                for k, v in m.items()}},
            "bf16": {"cut": cut, "params": n_params,
                     "layers": cfg.num_layers, "batch": b, "seq": s,
                     "losses": losses, "grad_norms": norms,
                     "first_step_ms": 1e3 * secs[0], "ms_per_step": ms,
                     "tokens_per_s": b * s / (ms / 1e3),
                     "peak_memory_bytes": peak,
                     "profiled_step": {
                         "wall_ms": wall_ms, "device_busy_ms": busy,
                         "top": [{"ms": t, "calls": c, "kernel": k[:90]}
                                 for t, c, k in rows[:8]]}}}
        if arch == "hymba_1_5b":
            del state
            # 4 x 512 tokens, where the activations a policy keeps outweigh
            # the gradients' own peak at the end of backward
            long = example_batch(cfg, 4, 512, 2, device=dev)
            peaks = {r: _remat_memory(cfg, params, long, r)
                     for r in ("none", "dots", "full")}
            log("  hymba_1_5b one gradient pass over 4 x 512 tokens, bytes "
                "above the parameters: " + ", ".join(
                    f"{r} forward peak {p['forward_peak'] / 1e9:.3f} GB, "
                    f"pass peak {p['pass_peak'] / 1e9:.3f} GB"
                    for r, p in peaks.items()))
            fwd = [peaks[r]["forward_peak"] for r in ("none", "dots", "full")]
            if not fwd[0] >= fwd[1] >= fwd[2]:
                raise AssertionError(f"remat forward peaks not none >= dots "
                                     f">= full: {peaks}")
            out[arch]["remat_memory_bytes"] = peaks
        del params
        state = None
        free_memory()
        log(f"  {arch} training took {time.perf_counter() - t_arch:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the roofline on the card
# ---------------------------------------------------------------------------
def phase_roofline(training: dict) -> dict:
    """The dry-run's analysis (``launch/dryrun.py``: the step traced once on
    ``meta`` tensors over a placeholder process group) of the four bf16
    train steps phase 8 timed, on the (1, 1) mesh with phase 8's configs
    (4 x 64, ``remat="full"``), held against what phase 8 measured: the
    roofline time (the larger of its compute and memory terms over the
    H100's datasheet rates) must not exceed the profiled step's device-busy
    time, since a lower bound above a measurement means the count is
    wrong. Prints each term, the bottleneck, the measured ms a step and
    device-busy ms and their ratios to the roofline, and the trace's peak
    live bytes against ``torch.cuda.max_memory_allocated``. Runs no step
    on the card. Then traces one production combination (``llama3_2_3b``
    ``train_4k`` on the 256-rank mesh) and prints its row."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.analysis import analyze, model_flops_estimate
    from repro_torch.launch.dryrun import lower_combo, step_cost
    from repro_torch.launch.mesh import make_cpu_mesh, placeholder_world

    measured = {"llama3_2_3b": training["lm"]["llama3_2_3b_bf16"],
                **{arch: training["families"][arch]["bf16"]
                   for arch in ("hymba_1_5b", "rwkv6_7b", "whisper_tiny")}}
    out = {}
    for arch, m in measured.items():
        cfg = get_config(arch)
        if not cfg.is_encdec:
            cfg = cfg.replace(num_layers=m["layers"])
        shape = InputShape("card_train", m["seq"], m["batch"], "train")
        with placeholder_world(1):
            cost, trace_s = step_cost(cfg, shape, make_cpu_mesh(),
                                      remat="full")
        rl = analyze(cost, arch=arch, shape=shape.name, mesh_name="card1x1",
                     n_devices=1, model_flops=model_flops_estimate(cfg,
                                                                   shape))
        bound_ms = 1e3 * rl.t_bound
        busy = m["profiled_step"]["device_busy_ms"]
        ms = m["ms_per_step"]
        peak = m["peak_memory_bytes"]
        row = {"layers": cfg.num_layers, "t_compute_ms": 1e3 * rl.t_compute,
               "t_memory_ms": 1e3 * rl.t_memory, "bound_ms": bound_ms,
               "bottleneck": rl.bottleneck, "ms_per_step": ms,
               "device_busy_ms": busy, "step_over_bound": ms / bound_ms,
               "busy_over_bound": busy / bound_ms,
               "predicted_peak_bytes": cost.peak_bytes,
               "measured_peak_bytes": peak,
               "peak_predicted_over_measured": cost.peak_bytes / peak,
               "flops": cost.flops, "bytes": cost.bytes, "trace_s": trace_s}
        log(f"  {arch} ({cfg.num_layers} layers) 4 x 64 bf16 remat=full: "
            f"t_compute {row['t_compute_ms']:.3f} ms, t_memory "
            f"{row['t_memory_ms']:.3f} ms -> {rl.bottleneck}; measured "
            f"{ms:.1f} ms a step ({row['step_over_bound']:.2f}x the "
            f"roofline), device busy {busy:.1f} ms "
            f"({row['busy_over_bound']:.2f}x); peak predicted "
            f"{cost.peak_bytes / 1e9:.2f} GB, measured {peak / 1e9:.2f} GB "
            f"(ratio {row['peak_predicted_over_measured']:.3f}); traced in "
            f"{trace_s:.1f} s")
        if bound_ms > busy:
            raise AssertionError(f"{arch}: the roofline ({bound_ms:.3f} ms) "
                                 f"exceeds the measured device-busy time "
                                 f"({busy:.3f} ms): the count is wrong")
        out[arch] = row
    cost, meta = lower_combo("llama3_2_3b", "train_4k")
    cfg = get_config("llama3_2_3b")
    rl = analyze(cost, arch="llama3_2_3b", shape="train_4k",
                 mesh_name=meta["mesh"], n_devices=meta["n_devices"],
                 model_flops=model_flops_estimate(cfg,
                                                  INPUT_SHAPES["train_4k"]))
    log(f"  production combination: {rl.row()} mem/dev "
        f"{rl.memory_gb_per_device:.2f} GB, trace_s {meta['trace_s']:.1f}")
    out["production"] = {**rl.asdict(), "trace_s": meta["trace_s"]}
    return out


# ---------------------------------------------------------------------------
# Phase 9: the paper's benchmarks on the card
# ---------------------------------------------------------------------------
# the reference's bars (tests/test_system.py): Table II's alpaca/gpt4
# pairwise tau_b, and oracle <= native PARS x 1.001 < FCFS in each
# cross-model cell
TAU_BAR = 0.45
ORACLE_SLACK = 1.001
TABLE_BENCHES = ("table1", "table2", "table3", "table4", "cross_model",
                 "pars_plus")
BENCH_FILE = ROOT / "chiprun_out" / "BENCH_torch.json"


def _bench_summary(sections: dict) -> dict:
    """The numbers of phase 9's JSON line: tau per table cell, speedups,
    dispatches, launches and the wall seconds of each bench."""
    cross = sections["cross_model"]["cells"]
    adm = sections["prefill_admission"]
    return {
        "device": sections["table2"]["device"],
        "predictor": sections["table2"]["predictor"],
        "table2_tau": sections["table2"]["tau"],
        "table3_tau": sections["table3"]["tau"],
        "table4_tau": sections["table4"]["tau"],
        "cross_model": {k: {f: c[f] for f in (
            "tau_cross", "tau_native", "speedup_cross_vs_fcfs",
            "speedup_native_vs_fcfs")} for k, c in cross.items()},
        "pars_plus_best_gain_vs_pars":
            sections["pars_plus"]["best_pars_plus_gain_vs_pars"],
        "prefill_admission": {
            "width": adm["width"], "speedup": adm["speedup"],
            **{mode: {f: adm[mode][f] for f in (
                "dispatches", "prefill_s", "warmup_s", "wall_s",
                "launches")} for mode in ("sequential", "bucketed")}},
        "wall_s": {name: sec["wall_s"] for name, sec in sections.items()},
    }


@contextlib.contextmanager
def warmup_launches(kernels):
    """Counts, by wrapper name, the launches that ``Engine.warmup`` makes
    while the block runs: a paged pool's warm-up runs one eager decode step
    (and an MoE model's one eager first chunk) before it captures the
    graphs, whose captures launch nothing, and the engine twins count
    their runs' launches from after their warm-ups."""
    from repro_torch.serving.engine import Engine

    seen = {k.__name__: 0 for k in kernels}
    warmup = Engine.warmup

    def counted(self):
        before = {k.__name__: k.launches for k in kernels}
        try:
            return warmup(self)
        finally:
            for k in kernels:
                seen[k.__name__] += k.launches - before[k.__name__]
    Engine.warmup = counted
    try:
        yield seen
    finally:
        Engine.warmup = warmup


def phase_benchmarks(kernels) -> tuple:
    """The paper's benchmarks through the port on the card: the table and
    study twins (``benchmarks.torch_run``, FAST scale, mini predictor,
    every predictor trained on the card) and the admission twin at
    published width (``benchmarks.torch_prefill_admission --full``), with
    every count of ``kernels`` set to 0 just before it and read just after,
    less the engines' warm-ups (as the twin counts);
    the sections go to ``chiprun_out/BENCH_torch.json``, which must pass
    ``torch_check_bench --card``. Checks the reference's bars and that the
    admission twin ran the prefill kernel in every layer of every prefill
    dispatch, paged decode in its decode steps and no other kernel.
    The simulator serving twins run at the reference's ``--smoke`` sizes
    beside the tables. Returns the summary and the admission's launch
    counts."""
    from benchmarks import torch_prefill_admission, torch_run
    from benchmarks.torch_common import SERVING_BENCHES
    from repro_torch.configs import get_config

    BENCH_FILE.unlink(missing_ok=True)
    sections = torch_run.main(["--only", *TABLE_BENCHES, *SERVING_BENCHES,
                               "--smoke", "--json", str(BENCH_FILE)])
    for k in kernels:
        k.launches = 0
    with warmup_launches(kernels) as warm:
        sections["prefill_admission"] = torch_prefill_admission.main(
            ["--full", "--json", str(BENCH_FILE)])
    launches = {k.__name__: k.launches - warm[k.__name__] for k in kernels}

    problems = []
    tau = sections["table2"]["tau"]["alpaca/gpt4"]["pairwise"]
    if not tau >= TAU_BAR:
        problems.append(f"Table II alpaca/gpt4 pairwise tau_b {tau:.4f} "
                        f"< {TAU_BAR}")
    for cell, c in sections["cross_model"]["cells"].items():
        lat = c["avg_per_token_latency"]
        log(f"  cross_model {cell}: avg per-token latency fcfs "
            f"{lat['fcfs']:.4f}, cross {lat['cross']:.4f}, native "
            f"{lat['native']:.4f}, oracle {lat['oracle']:.4f} s")
        if not lat["oracle"] <= lat["native"] * ORACLE_SLACK:
            problems.append(f"{cell}: oracle above native PARS")
        if not lat["native"] < lat["fcfs"]:
            problems.append(f"{cell}: native PARS not below FCFS")
    adm = sections["prefill_admission"]
    layers = get_config(adm["arch"]).num_layers
    runs = adm["batch"] * adm["reps"]
    for mode in ("sequential", "bucketed"):
        m = adm[mode]
        counts = m["launches"]
        if m["finished"] != runs:
            problems.append(f"admission {mode}: {m['finished']} of {runs} "
                            f"finished")
        if counts["flash_attention"] != layers * m["dispatches"]:
            problems.append(f"admission {mode}: {counts['flash_attention']}"
                            f" prefill launches for {m['dispatches']} "
                            f"dispatches of {layers} layers")
        decode = counts["paged_decode_attention"]
        if decode == 0 or decode % layers:
            problems.append(f"admission {mode}: {decode} paged decode "
                            f"launches")
        strays = {k: v for k, v in counts.items() if v and k not in (
            "flash_attention", "paged_decode_attention")}
        if strays:
            problems.append(f"admission {mode}: another path's kernel "
                            f"launched: {strays}")
    if not adm["bucketed"]["dispatches"] < adm["sequential"]["dispatches"]:
        problems.append("bucketed admission made no fewer dispatches")
    if adm["width"] != "published":
        problems.append("the admission twin did not run at published width")
    total = {k: sum(adm[m]["launches"][k] for m in ("sequential",
                                                    "bucketed"))
             for k in launches}
    if total != launches:
        problems.append(f"the twin's counts {total} differ from the "
                        f"wrappers' {launches}")
    if problems:
        raise AssertionError(f"phase 9: {problems}")
    return _bench_summary(sections), launches


#: each engine twin's runs that serve, and the decode kernel each runs:
#: every other run it reports (the paged kernel's parity section)
#: compares a kernel with its plain version
TWIN_RUNS = {
    "paged_decode": {"contiguous": "ring_decode_attention",
                     "paged": "paged_decode_attention",
                     "tight_budget": "paged_decode_attention"},
    "chunked_prefill": {"calibration": "paged_decode_attention",
                        "unchunked": "paged_decode_attention",
                        "chunked": "paged_decode_attention"},
    "prefix_caching": {"uncached": "paged_decode_attention",
                       "cached": "paged_decode_attention"},
}
DECODE_KERNELS = ("paged_decode_attention", "ring_decode_attention")


def _twin_problems(name: str, section: dict, total: dict, layers: int):
    """Launch-count and bar violations of one engine twin's section:
    the prefill kernel in every layer of every prefill and extend
    dispatch, the run's decode kernel in a multiple of the layers, no
    other kernel; the twin's parts add up to the wrappers' counts."""
    problems = []
    real = section["real"]
    parts = {run: real[run] for run in TWIN_RUNS[name]}
    if "kernel" in section:
        parts["kernel parity"] = section["kernel"]
    for run, part in parts.items():
        counts = part["launches"]
        decode = TWIN_RUNS[name].get(run)
        if decode is None:
            continue
        dispatches = part["prefill_dispatches"] + part["extend_dispatches"]
        if counts["flash_attention"] != layers * dispatches:
            problems.append(f"{name} {run}: {counts['flash_attention']} "
                            f"prefill launches for {dispatches} dispatches "
                            f"of {layers} layers")
        if counts[decode] == 0 or counts[decode] % layers:
            problems.append(f"{name} {run}: {counts[decode]} {decode} "
                            f"launches")
        strays = {k: v for k, v in counts.items()
                  if v and k not in ("flash_attention", decode)}
        if strays:
            problems.append(f"{name} {run}: another path's kernel "
                            f"launched: {strays}")
    summed = {k: sum(p["launches"][k] for p in parts.values())
              for k in total}
    if summed != total:
        problems.append(f"{name}: the twin's counts {summed} differ from "
                        f"the wrappers' {total}")
    if section["width"] != "published" or section["real"]["dtype"] != \
            "float32":
        problems.append(f"{name} did not serve published width in f32")
    if section["real_identical_outputs"] is not True:
        problems.append(f"{name}: the two routes' tokens differ")
    return problems


def phase_serving_twins(kernels) -> tuple:
    """The serving benchmarks' engine halves on the card: the
    ``paged_decode``, ``chunked_prefill`` and ``prefix_caching`` twins at
    published ``llama3_2_3b`` width in f32 (``--full``, the reference's
    default sizes), every count of ``kernels`` set to 0 just before each
    twin and read just after, less the engines' warm-ups (each twin
    reports its runs' own counts);
    the kernel microbench twin; and ``examples/torch_serve_e2e.py --full``
    as a smoke test of the entry point. The sections go to
    ``BENCH_FILE``. Holds the reference's bars (identical tokens across
    the two routes, zero KV tokens copied on the paged hit path,
    grow-preemptions recovering, incremental reservation admitting
    >= 1.5x) and each kernel's launches. Returns the summary, the launches
    by twin and kernel, and the microbench's entries."""
    from benchmarks import (torch_chunked_prefill, torch_kernel_bench,
                            torch_paged_decode, torch_prefix_caching)
    from repro_torch.configs import get_config

    twins = {"paged_decode": torch_paged_decode,
             "chunked_prefill": torch_chunked_prefill,
             "prefix_caching": torch_prefix_caching}
    problems, summary, by_twin = [], {}, {}
    for name, mod in twins.items():
        t0 = time.perf_counter()
        for k in kernels:
            k.launches = 0
        with warmup_launches(kernels) as warm:
            section = mod.main(["--full", "--json", str(BENCH_FILE)])
        total = {k.__name__: k.launches - warm[k.__name__] for k in kernels}
        free_memory()
        wall = time.perf_counter() - t0
        layers = get_config(section["real"]["arch"]).num_layers
        problems += _twin_problems(name, section, total, layers)
        real = section["real"]
        by_twin[name] = {k: sum(real[run]["launches"][k]
                                for run in TWIN_RUNS[name]) for k in total}
        summary[name] = {"wall_s": wall, "launches": by_twin[name],
                         "real_identical_outputs":
                             section["real_identical_outputs"]}
        log(f"  {name} twin: {wall:.1f} s, launches {by_twin[name]}")
    data = json.loads(BENCH_FILE.read_text())
    pd = data["paged_decode"]
    tight = pd["real"]["tight_budget"]
    summary["paged_decode"].update(
        concurrency_ratio=pd["concurrency_ratio"],
        real_prefix_tokens_copied=pd["real_prefix_tokens_copied"],
        real_grow_preemptions=tight["grow_preemptions"],
        kernel_max_abs_err=pd["kernel"]["max_abs_err"])
    if not pd["concurrency_ratio"] >= 1.5:
        problems.append(f"paged_decode: concurrency ratio "
                        f"{pd['concurrency_ratio']} < 1.5")
    if pd["real_prefix_tokens_copied"] != 0:
        problems.append("paged_decode: the paged hit path copied KV")
    if not (tight["grow_failures"] > 0 and tight["grow_preemptions"] > 0):
        problems.append("paged_decode: the tight budget never preempted")
    ch = data["chunked_prefill"]["real"]
    summary["chunked_prefill"].update({
        f"{mode}_{k}": ch[mode][k] for mode in ("unchunked", "chunked")
        for k in ("itl_p50_s", "itl_p99_s", "itl_max_s", "ttft_p99_bg_s",
                  "ttft_mean_burst_s", "extend_dispatches")})
    pc = data["prefix_caching"]["real"]
    summary["prefix_caching"].update({
        f"{mode}_{k}": pc[mode][k] for mode in ("uncached", "cached")
        for k in ("ttft_mean_warm_s", "prefix_hit_rate",
                  "prefill_tokens_saved", "prefix_installs")})

    t0 = time.perf_counter()
    bench = torch_kernel_bench.main(["--json", str(BENCH_FILE)])
    free_memory()
    summary["kernels_wall_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_serve_e2e.py"),
         "--full", "--requests", "8", "--max-len", "16"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    summary["serve_e2e_wall_s"] = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  serve_e2e: {line}")
    rows = [line for line in proc.stdout.splitlines()
            if line.strip().startswith(("fcfs", "pars", "oracle"))]
    if proc.returncode != 0 or len(rows) != 3:
        problems.append(f"examples/torch_serve_e2e.py --full: rc "
                        f"{proc.returncode}, {len(rows)} policy rows; "
                        f"{proc.stderr[-2000:]}")
    if problems:
        raise AssertionError(f"phase 9 (serving twins): {problems}")
    return summary, by_twin, bench["kernels"]


def gate_bench_file() -> None:
    """``BENCH_FILE`` must pass ``torch_check_bench --card``."""
    from benchmarks import torch_check_bench

    errors = torch_check_bench.check(BENCH_FILE, card=True)
    if errors:
        raise AssertionError(f"{BENCH_FILE}: {errors}")
    log(f"  {BENCH_FILE.relative_to(ROOT)}: torch_check_bench --card passed")


def _tree_to(tree, device, dtype=None):
    """A copy of ``tree`` on ``device`` (floating leaves in ``dtype``)."""
    return {k: _tree_to(v, device, dtype) if isinstance(v, dict)
            else v.to(device, dtype if dtype and v.is_floating_point()
                      else v.dtype, copy=True) for k, v in tree.items()}


@contextlib.contextmanager
def f64_upcasts():
    """For a reference run on the CPU: every f32 tensor and upcast the port
    makes (``torch.float32``, ``Tensor.float()``, the default dtype) is f64
    until the block ends."""
    saved = torch.Tensor.float, torch.float32, torch.get_default_dtype()
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    torch.float32 = torch.float64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, torch.float32 = saved[:2]
        torch.set_default_dtype(saved[2])


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible; this script runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("== phase 1: build")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"built {len(logs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    log("== phase 2: kernels against their plain versions")
    entries = [phase_decode_kernel(dev), phase_prefill_kernel(dev),
               phase_ring_decode_kernel(dev),
               phase_linear_attention_kernel(dev)]
    for name, keys in phase_moe_vlm_instances(dev).items():
        next(e for e in entries if e["name"] == name).update(keys)
    for name, keys in phase_whisper_instances(dev).items():
        next(e for e in entries if e["name"] == name).update(keys)
    entries.append(phase_latent_decode_kernel(dev))
    entries[-1].update(phase_latent_decode_kernel_64(dev))
    for name, keys in (*phase_prefill_mla_instance(dev).items(),
                       *phase_prefill_mla_instance(
                           dev, KIMI_HEADS, KIMI_SCALE).items()):
        next(e for e in entries if e["name"] == name).update(keys)
    entries.append(phase_slot_positions_kernel(dev))

    log(f"== phase 3: parity at full width, 4 layers, f32 "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    phase_parity(dev)
    free_memory()
    phase_recurrent_parity(dev, "hymba_1_5b", 48)
    free_memory()
    phase_recurrent_parity(dev, "rwkv6_7b", 16)
    free_memory()
    phase_moe_parity(dev)
    free_memory()
    for arch in ("nemotron_4_15b", "moonshot_v1_16b_a3b", "qwen2_vl_72b"):
        phase_paged_smoke(dev, arch)
        free_memory()

    from repro_torch.kernels.flash_decode.ops import (
        latent_decode_attention, paged_decode_attention,
        ring_decode_attention)
    from repro_torch.kernels.flash_prefill.ops import flash_attention
    from repro_torch.kernels.moe_route.ops import slot_positions
    from repro_torch.kernels.rwkv6_chunk.ops import linear_attention
    served = {}
    everything = (paged_decode_attention, flash_attention,
                  ring_decode_attention, linear_attention)
    paged = (paged_decode_attention, flash_attention)
    # (arch, kernels of its path, layers where cut, policies)
    for arch, kernels, depth, policies in (
            ("llama3_2_3b", paged, None, ("pars", "fcfs")),
            ("hymba_1_5b", (ring_decode_attention, linear_attention,
                            flash_attention), None, ("pars", "fcfs")),
            ("rwkv6_7b", (linear_attention,), None, ("pars", "fcfs")),
            ("olmoe_1b_7b", (*paged, slot_positions), None,
             ("pars", "fcfs")),
            ("qwen2_vl_72b", paged, 16, ("pars",))):
        log(f"== phase 4: serving {arch} "
            f"({'full' if depth is None else f'{depth} layers'}) under "
            f"{' and '.join(p.upper() for p in policies)} "
            f"(at {time.perf_counter() - t_start:.1f} s)")
        idle = tuple(k for k in (*everything, latent_decode_attention,
                                 slot_positions) if k not in kernels)
        # only the RWKV path's launcher trains its predictor (phase 6
        # trains the same one): the other paths' launchers serve FCFS
        served[arch] = phase_serve(
            dev, arch, kernels, idle,
            launcher_policy="pars" if arch == "rwkv6_7b" else "fcfs",
            depth=depth, policies=policies)
    log(f"== phase 4: serving moonlight_16b_a3b (full) under PARS "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    served["moonlight_16b_a3b"] = phase_mla_serve(
        dev, tuple(k for k in everything if k is not flash_attention))
    log(f"== phase 4: serving kimi_k2_instruct (one H100's share) under "
        f"PARS (at {time.perf_counter() - t_start:.1f} s)")
    served["kimi_k2_instruct"] = phase_mla_serve(
        dev, tuple(k for k in everything if k is not flash_attention),
        "kimi_k2_instruct")
    log(f"== phase 4: olmoe_1b_7b's captured steps timed "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    phase_moe_steps(dev)
    log(f"== phase 4: whisper_tiny through build() "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    whisper = phase_whisper(dev, everything)
    served["whisper_tiny"] = whisper["bf16"]["launches"]
    # torch.profiler runs only now, so that no unprofiled burst follows a
    # profiler session (bursts that did were seen to run slower)
    log(f"== phase 5: kernel profiles "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    calls = {e["name"]: e.pop("call") for e in entries if "call" in e}
    for name, call in calls.items():
        log(f"  {name} at the record's shape, device ms per call by kernel: "
            f"{kernel_ms(call)}")
    # each kernel's launches in the PARS bursts of the paths that run it
    for e in entries:
        e["launches_by_path"] = {arch: run[e["name"]]
                                 for arch, run in served.items()
                                 if e["name"] in run}
        e["launches"] = sum(e["launches_by_path"].values())
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} never launched while serving")

    log(f"== phase 6: training the ranking predictor "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    predictor, training = phase_train_predictor(dev)
    training["determinism"] = phase_predictor_determinism()
    log(f"== phase 7: trained PARS on the served path "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    training["trained_pars_burst"] = phase_trained_pars(dev, predictor)
    del predictor
    log(f"== phase 8: training the LM (at {time.perf_counter() - t_start:.1f}"
        f" s)")
    training["lm"] = phase_train_lm(dev)
    free_memory()
    log(f"== phase 8: training the hybrid, SSM and encoder-decoder families "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    training["families"] = phase_train_families(dev)
    free_memory()
    log(f"== phase 9: the paper's benchmarks on the card "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    benchmarks, admission = phase_benchmarks(everything)
    log(f"== phase 9: the serving benchmarks' engine twins at published "
        f"width (at {time.perf_counter() - t_start:.1f} s)")
    benchmarks["serving_twins"], by_twin, bench_rows = phase_serving_twins(
        everything)
    gate_bench_file()
    for e in entries:
        for path, counts in (("prefill_admission", admission),
                             *by_twin.items()):
            if counts.get(e["name"]):
                e["launches_by_path"][path] = counts[e["name"]]
                e["launches"] += counts[e["name"]]
    # the microbench's shapes: prefill at S 512, ring decode over 8,192
    # rows, rwkv mode over 1,024 tokens
    for row in bench_rows:
        e = next(e for e in entries if e["name"] == row["name"])
        e.update({f"bench_{k}": v for k, v in row.items() if k != "name"})
    log(f"== phase 10: the roofline on the card, against phase 8's steps "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    t0 = time.perf_counter()
    training["roofline"] = phase_roofline(training)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"whisper": whisper}))
    print(json.dumps({"training": training}))
    print(json.dumps({"benchmarks": benchmarks}))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: v for k, v in e.items()
                                       if k not in keys}}
        for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
