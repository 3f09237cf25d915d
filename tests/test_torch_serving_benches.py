"""The port's simulator serving twins (``benchmarks/torch_{router,
iterative_rank,fault_tolerance,workload_harness}.py``) and the simulator
halves of its engine twins against the JAX benchmarks, at the reference's
``--smoke`` sizes; the serving-bench runner and the gate's device labels.

- Each simulator twin's ``BENCH.run`` equals the reference's result dict
  exactly (the simulator is the same code, copied).
- Each engine twin's ``run_sim`` equals the reference's.
- ``torch_check_bench`` passes on the simulator twins' sections (labelled
  ``"simulator"``), refuses a simulator section labelled otherwise and a
  device section labelled ``"simulator"``, and under ``--card`` refuses a
  device section measured on the CPU.
- The engine twins' default device (``cuda``) raises without a card.
"""
import dataclasses
import importlib
import json
import math
import runpy
import sys
from pathlib import Path

import pytest

import benchmarks.chunked_prefill as ref_chunked
import benchmarks.paged_decode as ref_paged
import benchmarks.prefix_caching as ref_prefix
import benchmarks.torch_check_bench as check_bench
import benchmarks.torch_chunked_prefill as port_chunked
import benchmarks.torch_common as port_common
import benchmarks.torch_kernel_bench as port_kernels
import benchmarks.torch_paged_decode as port_paged
import benchmarks.torch_prefix_caching as port_prefix

ROOT = Path(__file__).resolve().parents[1]


def _same(a, b, path="results"):
    """Exact equality, dataclasses as dicts, NaN equal to NaN."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("name", port_common.SERVING_BENCHES)
def test_simulator_twin_equals_reference_at_smoke(name):
    ref = importlib.import_module(f"benchmarks.{name}")
    port = importlib.import_module(f"benchmarks.torch_{name}")
    # the reference's BENCH under the same command line: its own runner
    # would write BENCH_serving.json
    expected = ref.BENCH.run(port_common.bench_args(ref.BENCH, ["--smoke"]))
    got = port.BENCH.run(port_common.bench_args(port.BENCH, ["--smoke"]))
    assert len(got) > 0
    _same(expected, got)
    section = port.BENCH.section(got)
    json.dumps(port_common._strict(section), allow_nan=False)


# the reference mains' --smoke arguments of each run_sim
SIM_SMOKE = {
    "paged_decode": (ref_paged, port_paged,
                     dict(n=8, out_len=32, kv_blocks=12, tight_blocks=5)),
    "chunked_prefill": (ref_chunked, port_chunked,
                        dict(n_bg=4, bg_len=60, n_burst=2)),
    "prefix_caching": (ref_prefix, port_prefix,
                       dict(n=8, shared_words=512, unique_words=31)),
}


@pytest.mark.parametrize("name", SIM_SMOKE)
def test_engine_twin_run_sim_equals_reference_at_smoke(name):
    ref, port, kw = SIM_SMOKE[name]
    _same(ref.run_sim(**kw), port.run_sim(**kw))


def _edit(path, tmp_path, edit):
    data = json.loads(path.read_text())
    edit(data)
    out = tmp_path / "edited.json"
    out.write_text(json.dumps(data))
    return out


def test_check_bench_holds_the_simulator_label(tmp_path):
    path = tmp_path / "BENCH_torch.json"
    untouched = {p: p.read_bytes() for p in (
        ROOT / "BENCH_torch.json", ROOT / "BENCH_serving.json")}
    for name in port_common.SERVING_BENCHES:
        mod = importlib.import_module(f"benchmarks.torch_{name}")
        section = mod.main(["--smoke", "--json", str(path)])
        assert section["device"] == "simulator"
        assert section["predictor"] is None and section["wall_s"] > 0
    assert {p: p.read_bytes() for p in untouched} == untouched
    # only the sections not run here are missing
    missing = {f"section missing: {s}" for s in check_bench.REQUIRED_SECTIONS
               if s not in port_common.SERVING_BENCHES}
    assert set(check_bench.check(path)) == missing
    assert set(check_bench.check(path, card=True)) == missing

    def device_section(d, label):
        d["kernels"] = {"kernels": [], "device": label, "scale": {},
                        "wall_s": 1.0, "predictor": None}

    assert set(check_bench.check(_edit(
        path, tmp_path, lambda d: d["router"].update(device="cpu")))) == \
        missing | {"router ran the simulator only, but its device says "
                   "'cpu'"}
    assert set(check_bench.check(_edit(
        path, tmp_path, lambda d: device_section(d, "simulator")))) == \
        missing - {"section missing: kernels"} | {
            "kernels ran on a device, but says 'simulator'"}
    cpu = _edit(path, tmp_path, lambda d: device_section(d, "cpu"))
    assert "kernels was measured on the CPU" not in check_bench.check(cpu)
    assert "kernels was measured on the CPU" in check_bench.check(cpu,
                                                                  card=True)


def test_engine_twins_default_device_raises_without_a_card(monkeypatch):
    """Every entry point of the engine twins, the kernel microbench and
    ``examples/torch_serve_e2e.py`` at its default device."""
    calls = [port_paged.run_real, port_paged.run_kernel,
             port_chunked.run_real, port_prefix.run_real, port_kernels.run]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    monkeypatch.setattr(sys, "argv", ["torch_serve_e2e.py"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runpy.run_path(str(ROOT / "examples" / "torch_serve_e2e.py"),
                       run_name="__main__")
