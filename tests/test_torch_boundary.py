"""The port's import boundary and its copies of framework-free modules.

The machine with the card has no JAX, so ``src/repro_torch``,
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` import neither ``jax``
nor anything of ``repro``; modules that need no framework are copies, held
here equal to their source with ``repro.`` rewritten to ``repro_torch.``.
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

# modules copied whole, and modules of which a subset of definitions is copied
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
    "serving/core.py", "data/__init__.py", "data/synthetic.py",
    "data/workload.py",
]
SUBSET_COPIES = ["serving/faults.py", "serving/metrics.py"]
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
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _rewrite(text):
    return text.replace("repro.", "repro_torch.")


def _port_sources():
    """The port, the card's smoke script, and the card-only tests (which
    run on the card's machine)."""
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "test_torch_cuda.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def test_port_imports_with_jax_and_reference_unavailable():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.bridge\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "import repro_torch.core.predictor\n"
            "import repro_torch.models.ssm\n"
            "import repro_torch.models.rwkv6\n"
            "import repro_torch.kernels.rwkv6_chunk.ops\n"
            "import repro_torch.training, repro_torch.launch.train\n"
            "from repro_torch.models import lm_loss\n"
            "assert not [m for m in sys.modules\n"
            "            if m.split('.')[0] in ('jax', 'repro')\n"
            "            and sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("rel", WHOLE_COPIES)
def test_whole_copy_equals_its_source(rel):
    """Equal to the rewritten source, but for the declared repairs."""
    expected = _rewrite((REF / rel).read_text())
    for old, new in REPAIRS.get(rel, []):
        assert expected.count(old) == 1, f"{rel}: repair target drifted"
        expected = expected.replace(old, new)
    assert (PORT / rel).read_text() == expected


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


def _definitions(text):
    """Top-level definitions by name -> their source text."""
    tree = ast.parse(text)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.get_source_segment(text, node)
    return out


@pytest.mark.parametrize("rel", SUBSET_COPIES)
def test_subset_copy_definitions_equal_their_source(rel):
    port = _definitions((PORT / rel).read_text())
    ref = _definitions(_rewrite((REF / rel).read_text()))
    assert port, rel
    for name, text in port.items():
        assert text == ref.get(name), f"{rel}: {name} drifted"


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
