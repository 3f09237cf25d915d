"""What the benchmark may import and read: no ``jax``, ``jaxlib``, ``flax``
or ``repro`` anywhere under ``bench/`` (top-level names compared whole:
``repro_torch`` is the program and allowed); nothing of the program, of
``benchmarks`` or of the harness in ``bench/reference/``; the program in
``bench/archs/`` only inside ``program_config``; no ``benchmarks/`` or
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


def modules(node) -> list:
    """The whole names of the modules an import statement imports."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module]
    return []


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
    """The references import nothing of the program, of ``benchmarks`` or
    of the harness and its architectures: only each other."""
    names = set(imported(path))
    assert not names & {"repro_torch", "benchmarks"}
    assert names <= {"__future__", "math", "re", "typing", "numpy", "torch",
                     "bench"}
    for node in ast.walk(ast.parse(path.read_text())):
        for mod in modules(node):
            if mod.split(".")[0] == "bench":
                assert mod == "bench.reference" or \
                    mod.startswith("bench.reference."), mod


@pytest.mark.parametrize("path", sorted((BENCH / "archs").glob("*.py")),
                         ids=lambda p: p.name)
def test_arch_imports_the_program_only_in_program_config(path):
    """An architecture module reaches the program only where
    ``serve.program_config`` does: inside its ``program_config``."""
    tree = ast.parse(path.read_text())
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                node.name == "program_config":
            inside.update(id(n) for n in ast.walk(node))
    for node in ast.walk(tree):
        if any(m.split(".")[0] == "repro_torch" for m in modules(node)):
            assert id(node) in inside, (path.name, node.lineno)


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
        "for p in (spec.BENCH / 'archs').glob('*.py'):\n"
        "    spec.arch(p.stem)\n"
        "bad = {n.split('.')[0] for n, v in sys.modules.items() if v}\n"
        "print(sorted(bad & {'jax', 'jaxlib', 'flax', 'repro'}))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
