"""The port's import boundary and its copies of framework-free modules.

The machine with the card has no JAX, so ``src/repro_torch``,
``chip_smoke.py``, ``tests/test_torch_cuda.py`` and the benchmark and
example twins (``benchmarks/torch_*.py``, ``examples/torch_*.py``) import
neither ``jax`` nor anything of ``repro``, nor ``benchmarks.common`` (which
imports JAX); modules that need no framework are copies, held here equal to
their source with ``repro.`` rewritten to ``repro_torch.``. The simulator
serving twins are their reference benches with ``benchmarks.common`` also
rewritten to ``benchmarks.torch_common``, and the engine twins' simulator
halves are the reference's functions; both drop the reference's issue tags
from their comments.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

# modules copied whole
WHOLE_COPIES = [
    "configs/__init__.py", "configs/base.py", "configs/llama3_2_3b.py",
    "configs/hymba_1_5b.py", "configs/pars_bert_base.py",
    "configs/command_r_35b.py", "configs/kimi_k2_1t_a32b.py",
    "configs/moonshot_v1_16b_a3b.py", "configs/nemotron_4_15b.py",
    "configs/olmoe_1b_7b.py", "configs/qwen2_vl_72b.py",
    "configs/rwkv6_7b.py", "configs/whisper_tiny.py", "core/__init__.py",
    "core/scheduler/__init__.py", "core/scheduler/request.py",
    "core/scheduler/policies.py", "core/scheduler/scheduler.py",
    "core/predictor/tokenizer.py", "core/predictor/pairing.py",
    "core/predictor/metrics.py", "serving/config.py", "serving/kv_cache.py",
    "serving/core.py", "serving/faults.py", "serving/metrics.py",
    "serving/router.py", "serving/workloads.py", "serving/simulator.py",
    "data/__init__.py", "data/synthetic.py", "data/workload.py",
    "launch/hlo_cost.py",
]
# whole copies that repair a fault of their source: (source text, port text)
# replacements, applied after the rewrite
REPAIRS = {
    # the hidden-length seed: the reference's hash() of a str tuple is salted
    # per process (PYTHONHASHSEED), so its lengths differ between processes
    "data/synthetic.py": [
        ("from dataclasses import dataclass\n",
         "import zlib\nfrom dataclasses import dataclass\n"),
        ("    hidden_rng = np.random.default_rng(\n"
         "        hash((corpus.dataset, corpus.seed, model)) % 2**32)\n",
         "    # not hash(): Python salts the hash of a str per process, so the "
         "seed\n"
         "    # (and every length) would change from one process to the next\n"
         "    hidden_rng = np.random.default_rng(\n"
         "        zlib.crc32(repr((corpus.dataset, corpus.seed, model))"
         ".encode()))\n"),
    ],
}
# benchmark twins copied whole: the reference's text with its shared
# module's and its package's names rewritten and its issue tags dropped
# (``_rewrite_bench``)
BENCH_COPIES = ["router", "iterative_rank", "fault_tolerance",
                "workload_harness"]
# functions the engine twins copy from their reference benches
BENCH_FUNCTION_COPIES = [
    ("paged_decode", "run_sim"), ("chunked_prefill", "_stats"),
    ("chunked_prefill", "_row"), ("chunked_prefill", "run_sim"),
    ("prefix_caching", "_stats"), ("prefix_caching", "_row"),
    ("prefix_caching", "run_sim"),
]
FORBIDDEN = {"jax", "jaxlib", "repro"}
# modules forbidden by their full name (the JAX benchmarks' shared module)
FORBIDDEN_MODULES = {"benchmarks.common"}


def _rewrite(text):
    return text.replace("repro.", "repro_torch.")


def _drop_issue_tags(text):
    """The reference benches tag their bars with the development issue that
    set them ("ISSUE acceptance bar", "Acceptance bar (ISSUE)"); the
    copies keep the bars and drop the tag."""
    return text.replace(" (ISSUE)", "").replace("ISSUE acceptance",
                                                "acceptance")


def _rewrite_bench(text):
    return _drop_issue_tags(_rewrite(text.replace("benchmarks.common",
                                                  "benchmarks.torch_common")))


def _port_sources():
    """The port, the card's smoke script, the card-only tests, and the
    benchmark and example twins (all of which run on the card's machine)."""
    return (sorted(PORT.rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
            + sorted((ROOT / "benchmarks").glob("torch_*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py")))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
            names += [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            assert (name.split(".")[0] not in FORBIDDEN
                    and name not in FORBIDDEN_MODULES), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


# run first in a child interpreter: JAX, the JAX package and the JAX
# benchmarks' shared module cannot be imported
_BLOCKED = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['benchmarks.common'] = None\n")
_NOTHING_BLOCKED_LOADED = (
    "assert not [m for m in sys.modules\n"
    "            if (m.split('.')[0] in ('jax', 'repro')\n"
    "                or m == 'benchmarks.common')\n"
    "            and sys.modules[m] is not None]\n")


def _run_blocked(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    return subprocess.run([sys.executable, "-c", _BLOCKED + code],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=120)


def test_port_imports_with_jax_and_reference_unavailable():
    code = ("import repro_torch, repro_torch.bridge\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "import repro_torch.core.predictor\n"
            "import repro_torch.models.ssm\n"
            "import repro_torch.models.rwkv6\n"
            "import repro_torch.kernels.rwkv6_chunk.ops\n"
            "import repro_torch.training, repro_torch.launch.train\n"
            "from repro_torch.models import lm_loss\n"
            "import repro_torch.serving.simulator\n"
            "import repro_torch.serving.router\n"
            "import repro_torch.serving.workloads\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.cost\n"
            "import repro_torch.launch.analysis, repro_torch.launch.hlo_cost\n"
            "import repro_torch.sharding.specs, repro_torch.sharding.local\n"
            "import benchmarks.torch_run, benchmarks.torch_check_bench\n"
            "import benchmarks.torch_roofline\n"
            "for name in benchmarks.torch_run.MODULES.values():\n"
            "    __import__('benchmarks.' + name)\n"
            + _NOTHING_BLOCKED_LOADED)
    proc = _run_blocked(code)
    assert proc.returncode == 0, proc.stderr


def test_table1_twin_runs_with_jax_and_reference_unavailable(tmp_path):
    """``python -m benchmarks.torch_run --device cpu --only table1`` with
    JAX, the JAX package and ``benchmarks.common`` blocked."""
    out = tmp_path / "bench.json"
    code = ("import runpy\n"
            "sys.argv = ['torch_run', '--device', 'cpu', '--only', 'table1',"
            f" '--json', {str(out)!r}]\n"
            "runpy.run_module('benchmarks.torch_run', run_name='__main__')\n"
            + _NOTHING_BLOCKED_LOADED)
    proc = _run_blocked(code)
    assert proc.returncode == 0, proc.stderr
    assert "table1_variability," in proc.stdout
    assert '"device": "cpu"' in out.read_text()


def test_dryrun_runs_with_jax_and_reference_unavailable(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one production combination
    with JAX, the JAX package and ``benchmarks.common`` blocked."""
    code = ("import runpy\n"
            "sys.argv = ['dryrun', '--arch', 'whisper-tiny', '--shape', "
            f"'decode_32k', '--out', {str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            + _NOTHING_BLOCKED_LOADED)
    proc = _run_blocked(code)
    assert proc.returncode == 0, proc.stderr
    assert "dry-run: all combos traced" in proc.stdout
    assert len(list(tmp_path.glob("*.json"))) == 1


@pytest.mark.parametrize("rel", WHOLE_COPIES)
def test_whole_copy_equals_its_source(rel):
    """Equal to the rewritten source, but for the declared repairs."""
    expected = _rewrite((REF / rel).read_text())
    for old, new in REPAIRS.get(rel, []):
        assert expected.count(old) == 1, f"{rel}: repair target drifted"
        expected = expected.replace(old, new)
    assert (PORT / rel).read_text() == expected


@pytest.mark.parametrize("name", BENCH_COPIES)
def test_benchmark_twin_equals_its_source(name):
    bench = ROOT / "benchmarks"
    assert (bench / f"torch_{name}.py").read_text() == \
        _rewrite_bench((bench / f"{name}.py").read_text())


@pytest.mark.parametrize("bench,function", BENCH_FUNCTION_COPIES)
def test_engine_twin_function_equals_its_source(bench, function):
    import importlib
    import inspect

    ref = importlib.import_module(f"benchmarks.{bench}")
    port = importlib.import_module(f"benchmarks.torch_{bench}")
    assert inspect.getsource(getattr(port, function)) == \
        _drop_issue_tags(inspect.getsource(getattr(ref, function)))


def test_sample_lengths_equal_the_reference_under_a_stable_seed(
        monkeypatch):
    """The port's lengths are the reference's, with its per-process hash
    replaced by the port's stable seed."""
    import zlib

    import numpy as np

    from repro.data import synthetic as ref
    from repro_torch.data import synthetic as port

    monkeypatch.setattr(ref, "hash", lambda t: zlib.crc32(repr(t).encode()),
                        raising=False)
    for dataset, model in (("alpaca", "llama"), ("lmsys", "r1")):
        c = port.make_corpus(dataset, 200, seed=3)
        rc = ref.make_corpus(dataset, 200, seed=3)
        assert c.prompts == rc.prompts
        np.testing.assert_array_equal(
            port.sample_lengths(c, model, run_seed=1, n_runs=2),
            ref.sample_lengths(rc, model, run_seed=1, n_runs=2))


def test_sample_lengths_are_the_same_in_every_process():
    """Two processes with different hash salts draw the same lengths."""
    code = ("from repro_torch.data.synthetic import make_corpus, "
            "sample_lengths\n"
            "print(sample_lengths(make_corpus('alpaca', 50, seed=1), "
            "'llama').tolist())\n")
    outs = set()
    for salt in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONHASHSEED=salt)
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.add(proc.stdout)
    assert len(outs) == 1


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
