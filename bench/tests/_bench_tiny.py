"""Test-only cells at smoke widths: built here from the real files, never
listed in ``BENCHMARK.json``, so the harness cannot find them as cells.

A configuration's smoke widths are data, ``bench/tests/tiny/<config>.json``:
what differs from ``bench/configs/<config>.json`` (nested groups merged key
by key), so that a new configuration brings its own as a new file."""
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import spec  # noqa: E402

TINY = Path(__file__).resolve().parent / "tiny"
CONFIG = {"moe": "olmoe_1b_7b", "hybrid": "hymba_1_5b"}
LIMITS = {"logit_gap": 1e-3, "logit_gap_mean": 1e-4, "score_gap": 1e-4,
          "prefix_hits": 0}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def config(family: str, dtype: str = "bfloat16",
           capacity_factor: float = 1.25) -> dict:
    """The configuration ``family`` (a key of ``CONFIG``, or a file's
    name) at its smoke widths, in ``dtype``, under the tests' limits."""
    name = CONFIG.get(family, family)
    cfg = _merge(copy.deepcopy(spec.load_json(
        spec.BENCH / "configs" / f"{name}.json")),
        spec.load_json(TINY / f"{name}.json"))
    cfg["model"]["dtype"] = dtype
    if cfg["model"].get("moe"):
        cfg["model"]["moe"]["capacity_factor"] = capacity_factor
    cfg["limits"] = dict(LIMITS)
    return cfg


def configs_of(arch: str) -> list:
    """Every smoke-width configuration whose file names ``arch``."""
    return [config(p.stem) for p in sorted(TINY.glob("*.json"))
            if spec.arch_name(spec.load_json(
                spec.BENCH / "configs" / p.name)) == arch]


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
    cfg = config(family, **cfg_kw)
    return spec.Cell(name=name, chips=1, config=cfg,
                     arch=spec.arch(spec.arch_name(cfg)),
                     mix=mix(kind),
                     own={"burst_interval_s": 1.5} if kind == "burst" else {},
                     end_to_end=metrics["end_to_end"],
                     per_layer=metrics["per_layer"])
