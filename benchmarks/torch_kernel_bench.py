"""Kernel microbenchmarks of the port: the reference's three shapes on the
card.

Twin of ``benchmarks/kernel_bench.py`` (no JAX), at its shapes:

* prefill (``flash_attention``): B 1, H 8, KH 2, S 512, dh 64, bf16,
  causal;
* ring decode (``ring_decode_attention``): B 4, H 8, KH 2, dh 128, lanes
  of W 8192 rows, every row at position W - 1 (the whole lane counts),
  bf16;
* chunked linear attention (``linear_attention``, ``rwkv`` mode): B 1,
  H 8, T 1024, dk = dv = 64, f32, log-decay ``-sigmoid(normal)``, bonus 0.

Per kernel, on the card: its error against its plain version at the
tolerances of the kernel tests (2e-2 in bf16, 5e-4 for the chunked kernel),
device-only milliseconds with the launches captured in a CUDA graph,
L2-warm (``device_ms``) and L2-cold (``cold_ms``: rotating over input
copies that read three times the 50 MB L2 between two uses),
back-to-back milliseconds (``ms``, CUDA events), the plain version's
(``plain_ms``), the least time the card could take (``bound_ms``: bytes
moved over the HBM rate or operations over the peak rate of their type,
whichever is larger) and, for the two attention shapes,
``scaled_dot_product_attention`` timed the same way (``library_*``; heads
expanded outside the timed call). On the CPU the wrappers are their plain
versions, so it reports only the plain versions' errors against the
port's model counterparts (``models/attention.py``'s ``attention_chunked``
and ``decode_attention``; the token-by-token recurrence of
``models/linear_attn.py``) and records no time.

    python -m benchmarks.torch_kernel_bench                 # on the card
    PYTHONPATH=src python -m benchmarks.torch_kernel_bench --device cpu

The section (``kernels``) merges into ``BENCH_torch.json`` (or ``--json``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from benchmarks.torch_common import (BENCH_TORCH_JSON, emit,
                                     record_torch_bench, section_meta)
from benchmarks.torch_timing import (BF16_FLOPS_S, F32_FLOPS_S, HBM_BYTES_S,
                                     bound, cuda_ms, device_times)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_decode.ops import (ring_decode_attention,
                                                  ring_decode_attention_plain)
from repro_torch.kernels.flash_prefill.ops import (flash_attention,
                                                   flash_attention_plain)
from repro_torch.kernels.rwkv6_chunk.ops import linear_attention
from repro_torch.models.attention import attention_chunked, decode_attention
from repro_torch.models.linear_attn import (chunked_linear_attention,
                                            linear_attention_step)

PREFILL = dict(b=1, h=8, kh=2, s=512, dh=64)
DECODE = dict(b=4, h=8, kh=2, dh=128, w=8192)
RWKV = dict(b=1, h=8, t=1024, dk=64)
#: tolerances against the plain version (the kernel tests'): bf16, and
#: the chunked kernel's
BF16_TOL = 2e-2
RWKV_TOL = 5e-4


def _normal(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                           device=dev).to(dtype)


def prefill_inputs(b, h, kh, s, dh, *, dtype=torch.bfloat16,
                   device: DeviceLike = "cuda", seed: int = 0):
    """(q (B, H, S, dh), k, v (B, KH, S, dh), q_start 0, kv_len S)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, h, s, dh), dtype, dev)
    k = _normal(rng, (b, kh, s, dh), dtype, dev)
    v = _normal(rng, (b, kh, s, dh), dtype, dev)
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    return q, k, v, zero, torch.full_like(zero, s)


def decode_inputs(b, h, kh, dh, w, *, dtype=torch.bfloat16,
                  device: DeviceLike = "cuda", seed: int = 0):
    """(q (B, H, dh), lanes (B, KH, W, dh) heads first, slots 0..B-1, pos
    W - 1): the reference's ``(B, W, KH, dh)`` caches, transposed."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, h, dh), dtype, dev)
    k = _normal(rng, (b, w, kh, dh), dtype, dev).transpose(1, 2).contiguous()
    v = _normal(rng, (b, w, kh, dh), dtype, dev).transpose(1, 2).contiguous()
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    return q, k, v, slots, torch.full_like(slots, w - 1)


def rwkv_inputs(b, h, t, dk, *, device: DeviceLike = "cuda", seed: int = 0):
    """(q, k, v (B, H, T, dk) f32, log-decay -sigmoid(normal), bonus 0)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, (b, h, t, dk), torch.float32, dev)
               for _ in range(3))
    lw = -torch.sigmoid(_normal(rng, (b, h, t, dk), torch.float32, dev))
    return q, k, v, lw, torch.zeros(h, dk, device=dev)


def prefill_model(q, k, v):
    """The prefill plain version's model counterpart: ``attention_chunked``
    on the model's (B, S, H, dh) layout at absolute positions."""
    b, _, s, _ = q.shape
    pos = torch.arange(s, device=q.device)[None].expand(b, s)
    return attention_chunked(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), pos, pos).transpose(1, 2)


def decode_model(q, k_lanes, v_lanes, slots, pos):
    """The ring decode plain version's model counterpart:
    ``decode_attention`` on (B, W, KH, dh) caches."""
    idx = slots.long()
    return decode_attention(q, k_lanes[idx].transpose(1, 2),
                            v_lanes[idx].transpose(1, 2), pos)


def rwkv_recurrence(q, k, v, lw, bonus):
    """The chunked plain version's counterpart: the one-step update, token
    by token, from a zero state. Returns (out, final state)."""
    b, h, t, dk = q.shape
    state = torch.zeros(b, h, dk, v.shape[-1], device=q.device)
    outs = []
    for i in range(t):
        o, state = linear_attention_step(state, q[:, :, i], k[:, :, i],
                                         v[:, :, i], lw[:, :, i],
                                         bonus=bonus, mode="rwkv")
        outs.append(o)
    return torch.stack(outs, 2), state


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _check(name, err, tol):
    print(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: {err} > {tol}")


def _times(call, plain, make_call, bytes_read, iters) -> dict:
    """Back-to-back ms of the kernel and its plain version; device-only
    ms, L2-warm and L2-cold."""
    t = {"ms": cuda_ms(call, iters), "plain_ms": cuda_ms(plain, 10)}
    t["device_ms"], t["cold_ms"] = device_times(make_call, bytes_read)
    return t


def _library(call, make_call, bytes_read, iters) -> dict:
    t = {"library_ms": cuda_ms(call, iters)}
    t["library_device_ms"], t["library_cold_ms"] = device_times(
        make_call, bytes_read)
    return t


def _copies(args, i):
    return args if i == 0 else tuple(x.clone() for x in args)


def bench_prefill(dev, iters: int) -> dict:
    b, h, kh, s, dh = (PREFILL[x] for x in ("b", "h", "kh", "s", "dh"))
    args = prefill_inputs(b, h, kh, s, dh, device=dev)
    q, k, v, _, _ = args
    plain = flash_attention_plain(*args)
    entry = {"name": "flash_attention", "shape": dict(PREFILL),
             "dtype": "bfloat16", "tol": BF16_TOL}
    entry["plain_vs_model_err"] = _err(plain, prefill_model(q, k, v))
    _check("prefill plain vs attention_chunked", entry["plain_vs_model_err"],
           entry["tol"])
    if dev.type != "cuda":
        return entry
    entry["max_abs_err"] = _err(flash_attention(*args), plain)
    _check("prefill kernel vs plain", entry["max_abs_err"], entry["tol"])
    bytes_moved = 2 * (2 * b * h * s * dh + 2 * b * kh * s * dh) + 8 * b
    flops = 4 * dh * b * h * s * (s + 1) // 2      # unmasked (query, key)
    entry["bound_ms"], entry["bound_by"] = bound(bytes_moved, flops)
    entry.update(_times(lambda: flash_attention(*args),
                        lambda: flash_attention_plain(*args),
                        lambda i: (lambda a=_copies(args, i):
                                   flash_attention(*a)),
                        bytes_moved, iters))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = (q, k.repeat_interleave(h // kh, 1).contiguous(),
           v.repeat_interleave(h // kh, 1).contiguous())
    entry.update(_library(lambda: sdpa(*lib, is_causal=True),
                          lambda i: (lambda a=_copies(lib, i):
                                     sdpa(*a, is_causal=True)),
                          2 * 4 * b * h * s * dh, iters))
    return entry


def bench_decode(dev, iters: int) -> dict:
    b, h, kh, dh, w = (DECODE[x] for x in ("b", "h", "kh", "dh", "w"))
    args = decode_inputs(b, h, kh, dh, w, device=dev)
    q, kl, vl, _, _ = args
    plain = ring_decode_attention_plain(*args)
    entry = {"name": "ring_decode_attention", "shape": dict(DECODE),
             "dtype": "bfloat16", "tol": BF16_TOL}
    entry["plain_vs_model_err"] = _err(plain, decode_model(*args))
    _check("ring decode plain vs decode_attention",
           entry["plain_vs_model_err"], entry["tol"])
    if dev.type != "cuda":
        return entry
    entry["max_abs_err"] = _err(ring_decode_attention(*args), plain)
    _check("ring decode kernel vs plain", entry["max_abs_err"], entry["tol"])
    bytes_moved = (2 * b * w * kh * dh * 2         # K and V rows, bf16
                   + 2 * b * h * dh * 2 + 2 * b * 4)
    entry["bound_ms"], entry["bound_by"] = bound(bytes_moved,
                                                 4 * b * w * h * dh)
    entry.update(_times(lambda: ring_decode_attention(*args),
                        lambda: ring_decode_attention_plain(*args),
                        lambda i: (lambda a=_copies(args, i):
                                   ring_decode_attention(*a)),
                        bytes_moved, iters))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = h // kh
    lib = (q[:, :, None, :].contiguous(),
           kl.repeat_interleave(g, 1).contiguous(),
           vl.repeat_interleave(g, 1).contiguous())
    entry.update(_library(lambda: sdpa(*lib),
                          lambda i: (lambda a=_copies(lib, i): sdpa(*a)),
                          sum(x.numel() * 2 for x in lib), iters))
    return entry


def bench_rwkv(dev, iters: int) -> dict:
    b, h, t, dk = (RWKV[x] for x in ("b", "h", "t", "dk"))
    q, k, v, lw, u = rwkv_inputs(b, h, t, dk, device=dev)
    out, state = chunked_linear_attention(q, k, v, lw, bonus=u, mode="rwkv",
                                          chunk_size=64)
    rec, rec_state = rwkv_recurrence(q, k, v, lw, u)
    entry = {"name": "linear_attention", "mode": "rwkv", "shape": dict(RWKV),
             "dtype": "float32", "tol": RWKV_TOL}
    entry["plain_vs_model_err"] = max(_err(out, rec),
                                      _err(state, rec_state))
    _check("rwkv plain vs recurrence (output and final state)",
           entry["plain_vs_model_err"], RWKV_TOL)
    if dev.type != "cuda":
        return entry
    got, got_state = linear_attention(q, k, v, lw, u, mode="rwkv")
    entry["max_abs_err"] = max(_err(got, out), _err(got_state, state))
    _check("rwkv kernel vs plain (output and final state)",
           entry["max_abs_err"], RWKV_TOL)
    c = 64
    bytes_moved = (4 * (q.numel() + k.numel() + v.numel() + lw.numel())
                   + 4 * out.numel() + 4 * state.numel() + 4 * u.numel())
    flops = b * h * (t // c) * (c * (c - 1) * 2 * dk    # scores, P V
                                + 4 * c * dk * dk       # state in/out
                                + 2 * c * 2 * dk)       # diagonal
    entry["bound_ms"], entry["bound_by"] = bound(bytes_moved, flops,
                                                 F32_FLOPS_S)
    entry.update(_times(
        lambda: linear_attention(q, k, v, lw, u, mode="rwkv"),
        lambda: chunked_linear_attention(q, k, v, lw, bonus=u, mode="rwkv",
                                         chunk_size=64),
        lambda i: (lambda a=_copies((q, k, v, lw), i):
                   linear_attention(*a, u, mode="rwkv")),
        bytes_moved, iters))
    entry["library_ms"] = None                  # no single PyTorch call
    return entry


def run(*, device: DeviceLike = "cuda", iters: int = 200) -> dict:
    """The three shapes' entries; times on the card only."""
    dev = resolve_device(device)
    entries = []
    for bench in (bench_prefill, bench_decode, bench_rwkv):
        entries.append(bench(dev, iters))
        e = entries[-1]
        if "device_ms" in e:
            emit(f"{e['name']}_cuda_{e['dtype']}", e["cold_ms"] * 1e3,
                 f"device-only L2-cold; warm {e['device_ms'] * 1e3:.2f} us, "
                 f"bound {e['bound_ms'] * 1e3:.2f} us ({e['bound_by']})"
                 + (f", SDPA {e['library_cold_ms'] * 1e3:.2f} us"
                    if e.get("library_cold_ms") is not None else ""))
    return {"kernels": entries, "bound_rates": {
        "hbm_bytes_s": HBM_BYTES_S, "bf16_flops_s": BF16_FLOPS_S,
        "f32_flops_s": F32_FLOPS_S}}


def section(results: dict) -> dict:
    return dict(results)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="benchmarks.torch_kernel_bench")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="merge the section into this file instead of "
                    "BENCH_torch.json at the repo root")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    results = run(device=args.device)
    payload = {**section(results), **section_meta(args.device, None),
               "wall_s": time.perf_counter() - t0}
    record_torch_bench("kernels", payload, args.json or BENCH_TORCH_JSON)
    return payload


if __name__ == "__main__":
    main()
