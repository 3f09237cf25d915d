"""Operations and bytes from shapes: the useful work of a served token and
the least time of a decode attention call.

Useful work of a token: 2 FLOPs per active matmul parameter (attention
projections; the MLP; the router and the ``top_k`` routed experts, not the
padded capacity; the SSD projections; the output head), plus attention
(``4 H dh`` FLOPs per layer per position attended: scores and values) and
the SSD scan (``4 heads N head_dim`` per layer: state update and readout).

Decode attention (``kernels/flash_decode``, the bound formulas of
``PERF.md``'s kernel table): each row reads its K and V at every position
it attends, once, and the query, and writes its output; each input byte is
counted once whatever the kernel reads again. Operations: ``4 H dh`` per
position attended. The least time is the larger of bytes over the HBM rate
and operations over the bf16 peak.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from bench.harness import peaks

BF16 = 2


def matmul_params(m: dict) -> int:
    d, h, kh, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    per = d * (h + 2 * kh) * dh + h * dh * d
    if m.get("d_ff"):
        per += 3 * d * m["d_ff"]
    if m.get("moe"):
        e = m["moe"]
        per += d * e["num_experts"] + e["top_k"] * 3 * d * e["expert_d_ff"]
    if m.get("ssm"):
        s = m["ssm"]
        di = s["expand"] * d
        per += d * 2 * di + di * 2 * s["state_size"] \
            + di * (di // s["head_dim"]) + di * d
    return m["num_layers"] * per + d * m["vocab_size"]


def attended(m: dict, pos: int) -> int:
    """Positions a token at ``pos`` attends."""
    w = m.get("sliding_window")
    return min(pos + 1, w) if w else pos + 1


def tokens_flops(m: dict, positions) -> float:
    """Useful FLOPs of tokens at ``positions`` (an int array)."""
    positions = np.asarray(positions, np.int64)
    w = m.get("sliding_window")
    att = positions + 1 if not w else np.minimum(positions + 1, w)
    per_token = 0
    if m.get("ssm"):
        s = m["ssm"]
        di = s["expand"] * m["d_model"]
        per_token = 4 * (di // s["head_dim"]) * s["state_size"] \
            * s["head_dim"]
    per_layer = 4.0 * m["num_heads"] * m["head_dim"] * float(att.sum()) \
        + per_token * len(positions)
    return 2.0 * matmul_params(m) * len(positions) \
        + m["num_layers"] * per_layer


def decode_bound_s(m: dict, positions: Iterable[int], block: int = 0) -> float:
    """Least seconds of one layer's decode attention over rows at
    ``positions`` (``block``: the paged pool's block size, whose table
    entries the rows read; 0 for ring lanes)."""
    h, kh, dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    lens = [attended(m, p) for p in positions]
    kv = sum(lens) * kh * dh * BF16 * 2
    qo = len(lens) * h * dh * BF16 * 2
    meta = len(lens) * 4 + (sum(-(-n // block) for n in lens) * 4
                            if block else 0)
    flops = 4 * h * dh * sum(lens)
    return max((kv + qo + meta) / peaks.HBM_BYTES, flops / peaks.BF16_FLOPS)
