"""Test-only cells at smoke widths: built here from the real files, never
listed in ``BENCHMARK.json``, so the harness cannot find them as cells."""
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import spec  # noqa: E402

CONFIG = {"moe": "olmoe_1b_7b", "hybrid": "hymba_1_5b"}
LIMITS = {"logit_gap": 1e-3, "logit_gap_mean": 1e-4, "score_gap": 1e-4,
          "prefix_hits": 0}


def config(family: str, dtype: str = "bfloat16",
           capacity_factor: float = 1.25) -> dict:
    cfg = copy.deepcopy(spec.load_json(
        spec.BENCH / "configs" / f"{CONFIG[family]}.json"))
    m = cfg["model"]
    m.update(num_layers=2, d_model=64, num_heads=4, head_dim=16,
             vocab_size=512, dtype=dtype,
             num_kv_heads=4 if family == "moe" else 2)
    if family == "moe":
        m["moe"] = dict(m["moe"], num_experts=4, top_k=2, expert_d_ff=64,
                        group_size=64, capacity_factor=capacity_factor)
    else:
        m.update(d_ff=96, sliding_window=24)
        m["ssm"] = dict(m["ssm"], head_dim=16, state_size=8)
    cfg["engine"].update(max_batch=4, prompt_len=32, cache_len=64,
                         kv_blocks=16)
    if family == "moe":
        cfg["engine"]["prefill_chunk_tokens"] = 16
    cfg["predictor"]["train"].update(rows=200, epochs=1,
                                     pairs_per_epoch=256, batch_size=32)
    cfg["limits"] = dict(LIMITS)
    return cfg


def mix(kind: str) -> dict:
    m = copy.deepcopy(spec.load_json(spec.BENCH / "traffic"
                                     / f"lmsys-{kind}.json"))
    m.update(max_tokens=24, pool_rows=2000,
             prompt_tokens={"median": 10, "sigma": 1.0, "max": 32})
    if kind == "burst":
        m["burst_size"] = 6
    else:
        m["requests"] = 12
    return m


# the batch mix's metrics, whose readers stay in bench/metrics for the
# batch cell that PERF.md keeps under Open questions
BATCH_METRICS = {
    "end_to_end": [{"name": "setup_s", "unit": "s"},
                   {"name": "output_tokens_per_s", "unit": "tokens/s"}],
    "per_layer": [{"name": n, "unit": u} for n, u in (
        ("decode_batch_mean", "requests"), ("step_ms.batch", "ms"),
        ("step_mfu.batch", "%"), ("decode_attn_roofline.paged_batch", "%"),
        ("device_idle.batch", "%"))]}


def cell(family: str, kind: str, **cfg_kw) -> spec.Cell:
    """A cell of the benchmark's burst metrics (or the batch mix's) over the
    tiny config and mix."""
    name = f"tiny-{family}-{kind}"
    if kind == "burst":
        bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
        metrics = {"end_to_end": spec.metrics_of(bench["end_to_end"],
                                                 "olmoe-lmsys-burst"),
                   "per_layer": spec.per_layer_of(bench,
                                                  "olmoe-lmsys-burst")}
    else:
        metrics = BATCH_METRICS
    return spec.Cell(name=name, chips=1, config=config(family, **cfg_kw),
                     mix=mix(kind),
                     own={"burst_interval_s": 1.5} if kind == "burst" else {},
                     end_to_end=metrics["end_to_end"],
                     per_layer=metrics["per_layer"])
