"""The harness end to end on the CPU at smoke widths (the program's kernels
run their plain versions), the files found by name, the weights' layout,
and the refusal to run without a card."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bench_tiny as tiny  # noqa: E402

from bench.harness import cell as cell_mod, spec  # noqa: E402

ROOT = tiny.ROOT
CPU = torch.device("cpu")


def run(c, seed=2**33 + 5, seconds=3.0, trace=False, **kw):
    return cell_mod.run(c, seed, seconds, trace, CPU, time.perf_counter(),
                        log=lambda s: None, **kw)


@pytest.mark.parametrize("family,kind", [("moe", "burst"),
                                         ("hybrid", "burst"),
                                         ("moe", "batch")])
def test_cell_runs_and_reports_its_metrics(family, kind):
    """The end-to-end metrics of the cell, every request accounted, and the
    f32 program's served tokens are the reference's first choices (gap
    0)."""
    c = tiny.cell(family, kind, dtype="float32")
    out = run(c)
    res = out["result"]
    assert res["correct"], out["checks"]
    want = {m["name"] for m in c.end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] == len(out["window"].requests)
    assert res["failed"] == 0
    r = out["readings"]
    assert r["logit_gap"] == 0.0 and r["tokens"] >= 24
    assert r["score_gap"] < 1e-5 and r["prefix_hits"] == 0


def test_moe_drops_are_rebuilt_by_the_reference():
    """At capacity factor 0.5 the expert dispatch drops slots; the
    reference rebuilds each dispatch and still agrees exactly in f32."""
    c = tiny.cell("moe", "burst", dtype="float32", capacity_factor=0.5)
    out = run(c)
    assert out["readings"]["logit_gap"] == 0.0, out["readings"]


def test_traced_run_reports_per_layer_metrics():
    c = tiny.cell("moe", "burst")
    out = run(c, trace=True)
    got = set(out["result"]["metrics"])
    # the device readers find no device events on the CPU and stay silent
    assert {"rank_tau_b", "queue_wait_p95", "step_ms.burst",
            "step_mfu.burst", "prefill_share",
            "scorer_ms_per_request"} <= got
    assert "setup_s" not in got
    assert "decode_attn_roofline.paged" not in got


ARCHS = sorted(p.stem for p in (spec.BENCH / "archs").glob("*.py"))


@pytest.mark.parametrize("name", ARCHS)
def test_weights_have_the_program_layout(name):
    """Each architecture's drawn tree, at the smoke widths of every
    configuration that names it, is the program's ``init_params`` tree,
    and the same seed draws the same values."""
    from repro_torch.models import build

    def shapes(t, pre=""):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out.update(shapes(v, pre + k + "."))
            else:
                out[pre + k] = (tuple(v.shape), v.dtype)
        return out
    arch = spec.arch(name)
    configs = tiny.configs_of(name)
    assert configs, f"no bench/tests/tiny/<config>.json names {name!r}"
    for cfg_json in configs:
        cfg = arch.program_config(cfg_json)
        ours = arch.make_params(cfg, 3, CPU)
        theirs = build(cfg).init(3, device=CPU)
        assert shapes(ours) == shapes(theirs)
        again = arch.make_params(cfg, 3, CPU)
        assert torch.equal(ours["embed"], again["embed"])


def test_cells_and_metrics_are_found_by_name(tmp_path):
    """A throwaway cell, traffic, config, architecture and metric added as
    files and entries alone are found by name."""
    (tmp_path / "bench" / "configs").mkdir(parents=True)
    (tmp_path / "bench" / "traffic").mkdir()
    (tmp_path / "bench" / "cells").mkdir()
    (tmp_path / "bench" / "metrics").mkdir()
    (tmp_path / "bench" / "archs").mkdir()
    (tmp_path / "bench" / "archs" / "lm.py").write_text(
        (spec.BENCH / "archs" / "lm.py").read_text())
    (tmp_path / "bench" / "configs" / "toy.json").write_text(
        json.dumps(tiny.config("hybrid")))
    (tmp_path / "bench" / "traffic" / "toy-mix.json").write_text(
        json.dumps(tiny.mix("burst")))
    (tmp_path / "bench" / "cells" / "toy-cell.json").write_text(
        json.dumps({"burst_interval_s": 1.0}))
    (tmp_path / "bench" / "metrics" / "requests_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.attempted))\n")
    bench = {"workloads": [{"name": "toy-cell", "config": "toy",
                            "traffic": "toy-mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"},
                            {"name": "requests_seen", "unit": "requests",
                             "workloads": ["toy-cell"]}],
             "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.find("toy-cell", root=tmp_path)
    assert c.own == {"burst_interval_s": 1.0}
    assert c.arch is spec.arch("lm", root=tmp_path)
    assert [m["name"] for m in c.end_to_end] == ["setup_s", "requests_seen"]
    read = spec.reader("requests_seen", root=tmp_path)
    assert read(type("Ctx", (), {"attempted": [1, 2]})) == 2.0
    with pytest.raises(KeyError):
        spec.find("olmoe-lmsys-burst", root=tmp_path)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for the CPU")
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "olmoe-lmsys-burst", "--seed", "1", "--seconds",
                          "1"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
