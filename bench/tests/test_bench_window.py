"""The window arithmetic on hand-worked cases: per-token latency,
percentiles, tau_b, tokens in the window, failures, step time, useful
FLOPs, the decode bound and the admission inversion."""
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.harness import check, flops, peaks, serve, spec, stats  # noqa: E402


def req(rid, arrival, first, finish, n, start=None, score=0.0):
    return SimpleNamespace(req_id=rid, arrival_time=arrival,
                           first_token_time=first, finish_time=finish,
                           true_length=n, start_time=start, score=score,
                           scored=True)


def ctx(reqs, window=None, T=10.0, cut=12.0, model=None):
    return SimpleNamespace(attempted=reqs, cut=cut, T=T, model=model,
                           arch=spec.arch("lm"),
                           window=window or serve.Window(T, reqs),
                           engine={"block_size": 16}, engine_paged=True)


def test_per_token_latency_and_tails():
    reqs = [req(0, 0.0, 0.5, 2.0, 4), req(1, 1.0, 1.5, 5.0, 2),
            req(2, 1.0, None, None, 10)]        # failed: counted at the cut
    c = ctx(reqs, cut=12.0)
    # (2-0)/4 = 0.5, (5-1)/2 = 2.0, (12-1)/10 = 1.1
    assert spec.reader("latency_per_token_mean")(c) == pytest.approx(
        (0.5 + 2.0 + 1.1) / 3)
    # linear percentile of [0.5, 1.1, 2.0] at 90: 1.1 + 0.8 * 0.9
    assert spec.reader("latency_per_token_p90")(c) == pytest.approx(1.82)
    # ttft: 0.5, 0.5, 11.0 -> p95 = 0.5 + 0.9 * 10.5
    assert spec.reader("ttft_p95")(c) == pytest.approx(9.95)


def test_queue_wait_and_tau():
    reqs = [req(0, 0.0, 1, 2, 5, start=0.5, score=3.0),
            req(1, 0.0, 1, 2, 1, start=2.5, score=1.0),
            req(2, 0.0, 1, 2, 9, start=None, score=2.0)]
    c = ctx(reqs)
    assert spec.reader("queue_wait_p95")(c) == pytest.approx(0.5 + 0.95 * 2)
    # scores 3,1,2 vs lengths 5,1,9: pairs (0,1) +, (0,2) -, (1,2) + -> 1/3
    assert spec.reader("rank_tau_b")(c) == pytest.approx(1 / 3)
    assert stats.kendall_tau_b([1, 2, 3], [1, 1, 2]) == pytest.approx(
        2 / np.sqrt(6))


def test_tokens_in_window_and_rate():
    w = serve.Window(10.0, [])
    w.tokens_at = [(2.0, 100), (9.9, 500), (10.0, 510)]
    assert stats.tokens_in_window(w.tokens_at, 10.0) == 510
    assert spec.reader("output_tokens_per_s")(ctx([], w)) == 51.0


def test_step_time_scorer_prefill_and_batch():
    w = serve.Window(10.0, [])
    w.steps = [(0.0, 0.1, 4), (0.1, 0.3, 8), (9.9, 10.2, 8)]
    w.decode_calls = [(0.05, [1, 2, 3, 4], False), (0.2, [5] * 8, False),
                      (10.1, [6] * 8, False)]
    w.scorer_s, w.scored = 0.03, 12
    w.prefill_s, w.serve_s = 1.0, 4.0
    c = ctx([], w)
    assert spec.reader("step_ms.burst")(c) == pytest.approx(150.0)
    assert spec.reader("decode_batch_mean")(c) == pytest.approx(6.0)
    assert spec.reader("scorer_ms_per_request")(c) == pytest.approx(2.5)
    assert spec.reader("prefill_share")(c) == pytest.approx(25.0)


def test_useful_flops_count_routed_experts():
    m = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4, "d_ff": 0, "vocab_size": 10,
         "moe": {"num_experts": 4, "top_k": 2, "expert_d_ff": 3}}
    # per layer: qkv 8*(2+2)*4 + o 2*4*8 = 192; router 32; 2 experts 144
    assert flops.matmul_params(m) == 2 * (192 + 32 + 144) + 80
    # a token at position 2 attends 3 positions: 4*2*4*3 = 96 a layer
    assert flops.tokens_flops(m, [2]) == 2 * 816 + 2 * 96
    w = serve.Window(1.0, [])
    w.prefill_tokens = [(0.0, 0, 3)]
    w.decode_calls = [(0.5, [3], False), (2.0, [4], False)]
    got = spec.reader("step_mfu.batch")(ctx([], w, T=1.0, model=m))
    want = flops.tokens_flops(m, [0, 1, 2, 3]) / peaks.BF16_FLOPS * 100
    assert got == pytest.approx(want)


def test_decode_bound():
    m = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
         "sliding_window": 3}
    # rows at 0 and 9 attend 1 and 3 positions (window 3)
    kv = 4 * 2 * 8 * 2 * 2
    qo = 2 * 4 * 8 * 2 * 2
    want = max((kv + qo + 2 * 4) / peaks.HBM_BYTES,
               4 * 4 * 8 * 4 / peaks.BF16_FLOPS)
    assert flops.decode_bound_s(m, [0, 9]) == pytest.approx(want)


def test_admission_inversion():
    w = SimpleNamespace(admissions=[([0, 1], [2, 3]), ([2], [3])])
    ref = np.array([0.1, 0.5, 0.4, 0.9])
    at = {i: i for i in range(4)}
    # first admission: admitted max 0.5 above waiting min 0.4 by 0.1
    assert check._inversion(w, at, ref) == pytest.approx(0.1)
    # decided again by other scores, it admits {0, 2}: no inversion
    order = np.array([0.0, 0.6, 0.1, 1.0])
    assert check._inversion(w, at, ref, order) == 0.0


def test_sample_takes_the_longest():
    reqs = [SimpleNamespace(req_id=i, true_length=n)
            for i, n in enumerate([5, 50, 7, 9, 11])]
    got = check.sample(reqs, 3, tokens=60, most=4)
    assert got[0].req_id == 1 and sum(r.true_length for r in got) >= 60
    assert check.sample(reqs, 3, 60, 4) == got


def test_slice_busy_idle_and_roofline():
    from bench.harness.profile import Slice
    s = Slice(window_s=1.0)
    # two overlapping kernels and one apart: busy 0.3 s of 1 s
    s.device = [(0, 200_000_000, "paged_decode_split_kernel<a>"),
                (100_000_000, 250_000_000, "paged_decode_combine_kernel"),
                (900_000_000, 950_000_000, "gemm")]
    s.by_name = {"paged_decode_split_kernel<a>": (0.2, 1),
                 "paged_decode_combine_kernel": (0.15, 1), "gemm": (0.05, 1)}
    s.host = [(0, 1_000_000_000, "engine.decode", True),
              (300_000_000, 800_000_000, "aten::item", False)]
    assert s.busy_s == pytest.approx(0.3)
    assert s.kernel_s("paged_decode_") == (pytest.approx(0.35), 2)
    assert s.idle_gaps()[0] == ["engine.decode > aten::item",
                                pytest.approx(0.65)]
    w = serve.Window(10.0, [])
    w.slice = s
    w.decode_calls = [(1.0, [9, 19], True), (2.0, [5], False)]
    m = {"num_heads": 2, "num_kv_heads": 2, "head_dim": 4, "num_layers": 3}
    c = ctx([], w, model=m)
    assert spec.reader("device_idle.burst")(c) == pytest.approx(70.0)
    bound = 3 * flops.decode_bound_s(m, [9, 19], 16)
    assert spec.reader("decode_attn_roofline.paged")(c) == pytest.approx(
        100 * bound / 0.35)
    assert spec.reader("decode_attn_roofline.ring")(c) is None


def test_profiler_pauses_are_left_out():
    """The seconds in which a traced run's profiler started or stopped
    count in no wait, step or share."""
    w = serve.Window(10.0, [])
    w.paused = [(1.0, 1.5), (4.0, 6.0)]
    assert stats.paused_in(0.0, 10.0, w.paused) == pytest.approx(2.5)
    assert stats.paused_in(1.2, 5.0, w.paused) == pytest.approx(1.3)
    assert stats.paused_in(2.0, 3.0, w.paused) == 0.0
    # waits 3.8 - 1.3 and 0.5 -> p95 of [0.5, 2.5]
    reqs = [req(0, 1.2, 1, 2, 5, start=5.0), req(1, 2.0, 1, 2, 5, start=2.5)]
    assert spec.reader("queue_wait_p95")(ctx(reqs, w)) == pytest.approx(
        0.5 + 0.95 * 2.0)
    # the step across the second pause is left out of the mean
    w.steps = [(0.0, 0.1, 4), (3.9, 6.2, 4), (7.0, 7.3, 4)]
    assert spec.reader("step_ms.burst")(ctx([], w)) == pytest.approx(200.0)
    w.serve_s, w.prefill_s = 12.5, 2.5
    assert spec.reader("prefill_share")(ctx([], w)) == pytest.approx(25.0)


def test_host_meter_counts_steps_phases_and_collections():
    import gc
    host = serve.HostMeter()
    host.start()
    for _ in range(3):
        host.tick()
    gc.collect()
    host.stop()
    assert len(host.probe) == 3 and all(t > 0 for t in host.probe)
    assert sum(host.gc_n) >= 1 and host.cpu_s > 0 and host.wall_s > 0
    line = host.line([(0.0, 0.1, 4), (0.1, 0.3, 4)])
    assert line.startswith("host: 2 steps, step ms median 150.00")
    assert host._gc not in gc.callbacks
