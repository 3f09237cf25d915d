"""What the benchmark may import and read: no ``jax``, ``jaxlib``, ``flax``
or ``repro`` anywhere under ``bench/`` (top-level names compared whole:
``repro_torch`` is the program and allowed); nothing of the program or of
``benchmarks`` in ``bench/reference/``; no ``benchmarks/`` or
``BENCH_*.json`` read."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_or_reference_package(path):
    assert not set(imported(path)) & FORBIDDEN
    text = path.read_text()
    assert "BENCH_" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    names = set(imported(path))
    assert not names & {"repro_torch", "benchmarks"}
    assert names <= {"__future__", "math", "re", "typing", "numpy", "torch",
                     "bench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("bench."):
            assert node.module.startswith("bench.reference")


def test_prefix_name_is_not_the_reference_package():
    # compared whole: the program's name begins with the JAX package's
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_harness_loads_no_jax():
    """Import every module a run imports with ``jax`` made unimportable,
    and see nothing forbidden in ``sys.modules`` afterwards."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'repro'): sys.modules[m] = None\n"
        "import bench.run, bench.harness.cell, bench.harness.check\n"
        "import repro_torch.serving.engine, repro_torch.core.predictor\n"
        "from bench.harness import spec\n"
        "for m in spec.load_json(spec.ROOT / 'BENCHMARK.json')['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "bad = {n.split('.')[0] for n, v in sys.modules.items() if v}\n"
        "print(sorted(bad & {'jax', 'jaxlib', 'flax', 'repro'}))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
