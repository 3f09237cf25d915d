"""Kernel timing on the card, shared by ``chip_smoke.py`` and the kernel
microbenchmark twin (``benchmarks/torch_kernel_bench.py``).

Back-to-back calls timed with CUDA events (:func:`cuda_ms`: L2-warm, and at
small times partly the host's), calls captured in a CUDA graph and replayed
(:func:`device_ms`: the device alone), rotation over input copies that read
three times the 50 MB L2 between two uses (:func:`device_times`: L2-cold),
and the least time the card could take for a call (:func:`bound`). Imports
only torch and numpy.
"""
from __future__ import annotations

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM
# bytes/s, bf16 tensor-core FLOP/s (the main path's dtype) and f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12
L2_BYTES = 50e6


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters



def device_ms(calls, launches: int = 200) -> float:
    """Device milliseconds per call with the host out of the loop: rounds
    over ``calls`` (about ``launches`` calls in all) captured in one CUDA
    graph, replayed once warm and once timed with CUDA events. Calls that
    rotate over copies of their inputs (``cold_copies``) find them out of
    L2, as the served caller does; a single call finds them in L2."""
    rounds = max(1, launches // len(calls))
    for call in calls:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for call in calls:
                call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(calls))


def cold_copies(bytes_read: float) -> int:
    """Copies of a call's inputs to rotate over so that at least 3 x the
    50 MB L2 is read between two uses of one copy."""
    return int(np.ceil(3 * L2_BYTES / bytes_read)) + 1


def device_times(make_call, bytes_read: float):
    """(warm, cold) device milliseconds per call. ``make_call(i)`` makes
    copy i of the inputs (copy 0 may be the caller's own) and returns a
    call on it; the cold time rotates over ``cold_copies`` of them."""
    calls = [make_call(i) for i in range(cold_copies(bytes_read))]
    return device_ms(calls[:1]), device_ms(calls)


def bound(bytes_moved: float, flops: float,
          flops_s: float = BF16_FLOPS_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and the
    operations over the peak rate of their type (bf16 by default)."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / flops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
