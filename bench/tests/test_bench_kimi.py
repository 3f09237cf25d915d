"""The ``mla_ep`` architecture (Kimi-K2-Instruct, one chip's share of an
expert-parallel stage) in the harness, on the CPU at its smoke widths: the
cell is served and judged correct, its control and two planted faults
(the softmax scale without YaRN's mscale^2, the router choosing among the
held experts alone) are judged not correct, and its work counts are the
share's. YaRN's slowed rope pairs turn a few degrees over a smoke cell's
positions, too little for the check to see; ``tests/test_torch_kimi.py``
holds their frequencies to the hand values."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bench_tiny as tiny  # noqa: E402

from bench.harness import cell as cell_mod, spec  # noqa: E402

CPU = torch.device("cpu")
ARCH = spec.arch("mla_ep")
CELL = "kimi-k2-lmsys-burst"
# smoke-width limits of the bf16 control test, from its own readings on
# seeds 11-13: logit_gap_mean 0.0037-0.0123 for the program, 0.101-0.127
# for its fp8 control
SMOKE_LIMITS = {"logit_gap_mean": 0.04, "score_gap": 1e-4,
                "prefix_hits": 0}


def _cell(dtype="float32") -> spec.Cell:
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    return spec.Cell(name="tiny-kimi-burst", chips=1,
                     config=tiny.config("kimi_k2_instruct_ep8", dtype=dtype),
                     arch=ARCH, mix=tiny.mix("burst"),
                     own={"burst_interval_s": 1.5},
                     end_to_end=spec.metrics_of(bench["end_to_end"], CELL),
                     per_layer=spec.per_layer_of(bench, CELL))


def _run(c, seed=2**33 + 9, trace=False, **kw):
    return cell_mod.run(c, seed, 3.0, trace, CPU, time.perf_counter(),
                        log=lambda s: None, **kw)


def test_cell_is_served_and_correct_with_its_metrics():
    """f32 at smoke widths: every served token is the reference's best
    (gap 0), through the query path, YaRN and a share of the experts, with
    chunked prefill and decode through the latent pool; the traced run's
    host metrics are read, the device readers stay silent on the CPU."""
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
            "device_idle.burst"} <= names


def test_control_fails_where_the_program_passes():
    c = _cell("bfloat16")
    c.config["limits"] = dict(SMOKE_LIMITS)
    assert _run(c, seed=11)["result"]["correct"]
    out = _run(c, seed=11, control=True)
    assert not out["result"]["correct"], out["checks"]
    r = out["readings"]
    assert r["logit_gap_mean_control"] > SMOKE_LIMITS["logit_gap_mean"]


def _plant_mscale(monkeypatch):
    from repro_torch.models import mla
    monkeypatch.setattr(mla, "scale", lambda cfg: cfg.qk_head_dim ** -0.5)


def _plant_held_router(monkeypatch):
    from repro_torch.models import moe
    gates = moe._sigmoid_gates
    held = tiny.config("kimi_k2_instruct_ep8")["model"]["experts_held"]

    def among_held(logits, bias, k, routing):
        bias = bias.clone()
        bias[held:] = -1e9
        return gates(logits, bias, k, routing)
    monkeypatch.setattr(moe, "_sigmoid_gates", among_held)


@pytest.mark.parametrize("plant", [_plant_mscale, _plant_held_router],
                         ids=["scale_without_mscale",
                              "router_among_held_experts"])
def test_planted_fault_is_caught(monkeypatch, plant):
    plant(monkeypatch)
    out = _run(_cell())
    assert not out["result"]["correct"]
    gap = out["checks"]["logit_gap_mean"]
    assert gap["value"] > gap["limit"]


M = spec.load_json(spec.BENCH / "configs"
                   / "kimi_k2_instruct_ep8.json")["model"]


def test_work_counts_of_the_share():
    """Active matmul parameters of a token on this chip: MLA's 101.12 M a
    layer (the query path's two products among them), the dense layer's
    SwiGLU, the router over 384, 8 x 48/384 = 1 routed expert and the
    shared one, the head over 20,480 rows; attention 2 x 64 x (192 + 128)
    FLOPs per layer and attended position; the bounds are ``mla``'s at 64
    heads."""
    attn = (7168 * 1536 + 1536 * 64 * 192 + 7168 * 576 + 512 * 64 * 256
            + 64 * 128 * 7168)
    assert round(attn / 1e6, 2) == 101.12
    dense = attn + 3 * 7168 * 18432
    sparse = attn + 7168 * 384 + 1 * 3 * 7168 * 2048 + 3 * 7168 * 2048
    assert ARCH.matmul_params(M) == dense + 10 * sparse + 7168 * 20480
    pos = np.array([0, 9, 99])
    assert ARCH.tokens_flops(M, pos) == pytest.approx(
        2 * ARCH.matmul_params(M) * 3 + 11 * 2 * 64 * 320 * 111, rel=1e-12)
    mla = spec.arch("mla")
    assert ARCH.decode_bound_s(M, [4095, 159], 16) == \
        mla.decode_bound_s(M, [4095, 159], 16)
    assert ARCH.prefill_bound_s(M, [(0, 512)]) == \
        mla.prefill_bound_s(M, [(0, 512)])
