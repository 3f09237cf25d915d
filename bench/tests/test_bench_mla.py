"""The ``mla`` architecture (Moonlight-16B-A3B) in the harness, on the CPU
at its smoke widths: the cell is served and judged correct, its control
and three planted faults (the decode softmax scaled by 1/sqrt(576), the
router's selection bias ignored, the shared experts left out) are judged
not correct, its work counts are the published math's, and
``bench/mla_witness.py`` reads a fault planted in the reference as the
same fault planted in the program."""
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bench_tiny as tiny  # noqa: E402

from bench.harness import cell as cell_mod, peaks, serve, spec  # noqa: E402
from bench.harness.profile import Slice  # noqa: E402

CPU = torch.device("cpu")
ARCH = spec.arch("mla")
CELL = "moonlight-lmsys-burst"
# smoke-width limits of the bf16 control test, from its own readings on
# seeds 11-13: logit_gap_mean 0.0038-0.0119 for the program, 0.213-0.244
# for its fp8 control (the widest gap, 0.50-1.05 against 1.76-2.96, is
# read and not compared, as at the cell's own size)
SMOKE_LIMITS = {"logit_gap_mean": 0.05, "score_gap": 1e-4,
                "prefix_hits": 0}


def _cell(dtype="float32") -> spec.Cell:
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    return spec.Cell(name="tiny-mla-burst", chips=1,
                     config=tiny.config("moonlight_16b_a3b", dtype=dtype),
                     arch=ARCH, mix=tiny.mix("burst"),
                     own={"burst_interval_s": 1.5},
                     end_to_end=spec.metrics_of(bench["end_to_end"], CELL),
                     per_layer=spec.per_layer_of(bench, CELL))


def _run(c, seed=2**33 + 9, trace=False, **kw):
    return cell_mod.run(c, seed, 3.0, trace, CPU, time.perf_counter(),
                        log=lambda s: None, **kw)


def test_cell_is_served_and_correct_with_its_metrics():
    """f32 at smoke widths: every served token is the reference's best
    (gap 0), with chunked prefill and decode through the latent pool; the
    traced run's host metrics are read, the two device readers stay silent
    on the CPU."""
    c = _cell()
    out = _run(c, trace=True)
    assert out["result"]["correct"], out["checks"]
    assert out["readings"]["logit_gap"] == 0.0
    assert out["readings"]["tokens"] >= 100
    window = out["window"]
    assert any(s > 0 for call in window.prefill_calls for _r, s, _e in call)
    got = set(out["result"]["metrics"])
    assert {"step_ms.burst", "step_mfu.burst", "prefill_share",
            "rank_tau_b", "scorer_ms_per_request", "queue_wait_p95"} <= got
    assert not got & {"decode_attn_roofline.latent",
                      "prefill_attn_roofline.mla", "device_idle.burst"}
    names = {m["name"] for m in c.per_layer}
    assert {"decode_attn_roofline.latent", "prefill_attn_roofline.mla",
            "step_ms.burst", "step_mfu.burst", "device_idle.burst",
            "prefill_share", "rank_tau_b", "scorer_ms_per_request",
            "queue_wait_p95"} <= names
    assert "decode_attn_roofline.paged" not in names


def test_control_fails_where_the_program_passes():
    c = _cell("bfloat16")
    c.config["limits"] = dict(SMOKE_LIMITS)
    assert _run(c, seed=11)["result"]["correct"]
    out = _run(c, seed=11, control=True)
    assert not out["result"]["correct"], out["checks"]
    r = out["readings"]
    assert r["logit_gap_mean_control"] > SMOKE_LIMITS["logit_gap_mean"]
    assert r["score_gap_control"] > SMOKE_LIMITS["score_gap"]


def _plant_scale(monkeypatch):
    from repro_torch.models import mla
    monkeypatch.setattr(mla, "scale", lambda cfg: cfg.latent_dim ** -0.5)


def _plant_bias(monkeypatch):
    from repro_torch.models import moe
    gates = moe._sigmoid_gates
    monkeypatch.setattr(moe, "_sigmoid_gates",
                        lambda logits, bias, k, routing: gates(
                            logits, torch.zeros_like(bias), k, routing))


def _plant_shared(monkeypatch):
    build = serve.build

    def without_shared(cfg, params, *a, **kw):
        bare = {**params, "layers": {k: v for k, v in
                                     params["layers"].items() if k != "mlp"}}
        return build(cfg, bare, *a, **kw)
    monkeypatch.setattr(serve, "build", without_shared)


@pytest.mark.parametrize("plant", [_plant_scale, _plant_bias,
                                   _plant_shared],
                         ids=["scale_1_over_sqrt_576", "bias_ignored",
                              "shared_experts_left_out"])
def test_planted_fault_is_caught(monkeypatch, plant):
    plant(monkeypatch)
    out = _run(_cell())
    assert not out["result"]["correct"]
    gap = out["checks"]["logit_gap_mean"]
    assert gap["value"] > gap["limit"]


M = spec.load_json(spec.BENCH / "configs" / "moonlight_16b_a3b.json")["model"]


def test_work_counts_at_published_widths():
    """Active matmul parameters 2.58 B a token (2 FLOPs each; the output
    head's 0.34 B among them); attention 2 x 16 x (192 + 128) FLOPs per
    layer and attended position; a decode row reads 27 x 576 x 2 bytes a
    cached position."""
    active = ARCH.matmul_params(M)
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    dense = attn + 3 * 2048 * 11264
    sparse = attn + 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    assert active == dense + 26 * sparse + 2048 * 163840
    assert round(active / 1e9, 2) == 2.58
    pos = np.array([0, 9, 99])
    assert ARCH.tokens_flops(M, pos) == pytest.approx(
        2 * active * 3 + 27 * 2 * 16 * 320 * (1 + 10 + 100), rel=1e-12)
    rows = [4095, 4095]           # two rows of 4,096 positions: bytes bound
    want = 27 * (2 * 4096 * 576 * 2 + 2 * 16 * (576 + 512) * 2 + 2 * 4
                 + 2 * 256 * 4) / peaks.HBM_BYTES
    assert ARCH.decode_bound_s(M, rows, 16) == pytest.approx(want,
                                                             rel=1e-12)
    # a 512-token first chunk: 16 x 512 x 513 / 2 causal pairs
    flops = 27 * 2 * 16 * 320 * (512 * 513 // 2)
    nbytes = 27 * 2 * 512 * 16 * 320 * 2
    assert ARCH.prefill_bound_s(M, [(0, 512)]) == pytest.approx(
        max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES), rel=1e-12)


def _ctx(by_name, calls, tokens, paused):
    window = SimpleNamespace(
        slice=Slice(window_s=3.0, by_name=by_name), paused=paused,
        prefill_calls=calls, prefill_tokens=tokens,
        decode_calls=[(2.0, [99, 9], True), (2.5, [100, 10], True),
                      (9.0, [5], False)])
    return SimpleNamespace(window=window, arch=ARCH, model=M,
                           engine={"block_size": 16}, engine_paged=True)


def test_the_new_kernel_readers():
    """Each roofline share is its bound over the named kernel's device time
    in the slice: the decode steps the profiler saw, the prefill
    dispatches served between its start and its stop (a dispatch's
    padding lanes aside); silent where the kernel never ran."""
    decode = spec.reader("decode_attn_roofline.latent")
    prefill = spec.reader("prefill_attn_roofline.mla")
    calls = [[(1, 0, 64), (2, 0, 64)], [(3, 512, 1024)], [(4, 0, 8)]]
    tokens = [(1.5, 0, 60), (1.5, 0, 33), (2.2, 512, 700), (7.0, 0, 5)]
    by_name = {"void latent_decode_split_kernel<...>": (2e-4, 54),
               "void latent_decode_combine_kernel<...>": (1e-4, 54),
               "void flash_prefill_mla_kernel<192, 128>(...)": (1e-3, 54),
               "void paged_decode_split_kernel<...>": (5.0, 1)}
    ctx = _ctx(by_name, calls, tokens, [(0.9, 1.0), (3.0, 3.1)])
    bound = ARCH.decode_bound_s(M, [99, 9], 16) + \
        ARCH.decode_bound_s(M, [100, 10], 16)
    assert decode(ctx) == pytest.approx(100 * bound / 3e-4)
    bound = ARCH.prefill_bound_s(M, [(0, 64), (0, 64)]) + \
        ARCH.prefill_bound_s(M, [(512, 1024)])
    assert prefill(ctx) == pytest.approx(100 * bound / 1e-3)
    quiet = _ctx({}, calls, tokens, [(0.9, 1.0), (3.0, 3.1)])
    assert decode(quiet) is None and prefill(quiet) is None
    unsliced = _ctx(by_name, calls, tokens, [])
    unsliced.window.slice = None
    assert decode(unsliced) is None and prefill(unsliced) is None


@pytest.mark.parametrize("fault", ["scale_2.0", "bias_ignored"])
def test_witness_reads_a_fault_as_the_faulty_program(fault):
    """``bench/mla_witness.py`` in f32: with the fault planted in the
    program, the check reads the gaps the witness reads for the reference
    with the same fault, to rounding (the faulty program serves the faulty
    reference's best); rounding to bf16 reads below fp8, and every planted
    fault reads above 0."""
    from bench import mla_witness
    res = mla_witness.measure(_cell(), 2**33 + 9, 3.0, CPU,
                              log=lambda s: None, fault=fault)
    w = res["witness"]
    assert not res["out"]["result"]["correct"]
    for k in ("logit_gap_mean", "logit_gap", "logit_gap_share"):
        assert w["program"][k] == pytest.approx(w[fault][k], abs=1e-6)
    assert w["bf16"]["logit_gap_mean"] < w["fp8"]["logit_gap_mean"]
    assert min(w[f]["logit_gap_mean"] for f in mla_witness.FAULTS) > 0
