"""The port's benchmark twins (``benchmarks/torch_*.py``) against the JAX
benchmarks they twin, at a tiny scale.

- ``cross_model`` and ``pars_plus``: both get one fixed scorer whose
  ``.score`` returns the same numbers; their result dicts are exactly equal
  (the simulator is the same code).
- Tables II–IV on one (dataset, model): both frameworks train from bridged
  initial parameters; Kendall tau_b agrees within 0.01 per cell.
- ``prefill_admission`` at smoke width: the dispatches per mode equal the
  reference ``Engine``'s on the same bursts (its shape-grid warm-up
  skipped).
- ``torch_check_bench`` passes on a ``torch_run`` into a temporary file and
  fails when a section or a device entry is removed.
- Each twin that runs on a device raises at its default device without a
  card.

Both packages draw the same output lengths: the reference's per-process
salted ``hash()`` seed is replaced by the port's stable one
(``tests/test_torch_boundary.py``).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

import benchmarks.common as ref_common
import benchmarks.cross_model as ref_cross
import benchmarks.pars_plus_ablation as ref_plus
import benchmarks.prefill_admission as ref_admission
import benchmarks.table2_rank_methods as ref_table2
import benchmarks.table3_backbones as ref_table3
import benchmarks.table4_filtering as ref_table4
import benchmarks.torch_check_bench as check_bench
import benchmarks.torch_common as port_common
import benchmarks.torch_cross_model as port_cross
import benchmarks.torch_pars_plus_ablation as port_plus
import benchmarks.torch_prefill_admission as port_admission
import benchmarks.torch_run as torch_run
import benchmarks.torch_table2_rank_methods as port_table2
import benchmarks.torch_table3_backbones as port_table3
import benchmarks.torch_table4_filtering as port_table4
import repro.data.synthetic as ref_synthetic
from repro.core.predictor.backbones import PredictorConfig as JaxPCfg
from repro.core.predictor.backbones import init_predictor as jax_init
from repro.serving.engine import Engine as RefEngine
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.core.predictor import train as port_train

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(n_train=200, n_test=60, epochs=1, pairs_per_epoch=256,
            burst=100, sweep_requests=100)
# modules that read a scale() of their own (imported by name)
SCALED = (ref_common, ref_cross, ref_plus, port_common, port_cross,
          port_plus)
CACHES = (ref_common.corpus, ref_common.lengths, ref_common.get_predictor,
          port_common.corpus, port_common.lengths, port_common._trained)


def _clear_caches():
    for cache in CACHES:
        cache.cache_clear()


@pytest.fixture(scope="module")
def tiny():
    """Both benchmark packages at the tiny scale, drawing the same lengths;
    their caches cleared before and after."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in SCALED:
            bench_scale = (ref_common.BenchScale if mod in
                           (ref_common, ref_cross, ref_plus)
                           else port_common.BenchScale)
            mp.setattr(mod, "scale", lambda c=bench_scale: c(**TINY))
        mp.setattr(ref_synthetic, "hash",
                   lambda t: zlib.crc32(repr(t).encode()), raising=False)
        _clear_caches()
        yield mp
        _clear_caches()


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


class FixedScorer:
    """A predictor stand-in: the same scores in both packages."""

    def score(self, prompts):
        return np.asarray([float(zlib.crc32(p.encode()) % 1000)
                           for p in prompts])


@pytest.mark.parametrize("bench", ["cross_model", "pars_plus"])
def test_simulator_study_equals_reference_for_a_fixed_scorer(tiny, bench):
    ref, port = {"cross_model": (ref_cross, port_cross),
                 "pars_plus": (ref_plus, port_plus)}[bench]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (ref, port):
            mp.setattr(mod, "get_predictor",
                       lambda *a, **k: FixedScorer())
        expected = ref.run()
        got = port.run(device="cpu")
    assert len(got) == len(expected) > 0
    _same(expected, got)
    section = port.section(got)
    json.dumps(port_common._strict(section), allow_nan=False)


@pytest.fixture(scope="module")
def bridged_init(tiny):
    """The port's trainer starts from the reference's initial parameters
    for the same config and seed."""
    def init(cfg, seed=0, *, device="cuda"):
        jparams = jax_init(jax.random.PRNGKey(seed),
                           JaxPCfg(**dataclasses.asdict(cfg)))
        return bridge.params_from_flat(_flatten(jparams), device=device)
    tiny.setattr(port_train, "init_predictor", init)
    # one (dataset, model) cell in Tables III and IV (the full, not the
    # FAST, combos over these)
    one = {"gpt4": ref_synthetic.MODELS["gpt4"]}
    for mod in (ref_table3, ref_table4, port_table3, port_table4):
        tiny.setattr(mod, "FAST", False)
        tiny.setattr(mod, "DATASETS", ("alpaca",))
        tiny.setattr(mod, "MODELS", one)


def _tau_cells(results):
    """{(dataset, model, column): tau}; Table IV's rows are (without, with)."""
    out = {}
    for key, row in results.items():
        cols = (row.items() if isinstance(row, dict)
                else zip(("without", "with"), row))
        for col, tau in cols:
            out[(*key, col)] = tau
    return out


@pytest.mark.parametrize("table", ["table2", "table3", "table4"])
def test_table_tau_matches_reference_from_bridged_init(bridged_init, table):
    ref, port = {"table2": (ref_table2, port_table2),
                 "table3": (ref_table3, port_table3),
                 "table4": (ref_table4, port_table4)}[table]
    if table == "table2":
        expected = ref.run(datasets=("alpaca",), models=("gpt4",))
        got = port.run(datasets=("alpaca",), models=("gpt4",), device="cpu")
    else:
        expected = ref.run()
        got = port.run(device="cpu")
    expected, got = _tau_cells(expected), _tau_cells(got)
    assert got.keys() == expected.keys() and len(got) >= 2
    for cell, tau in expected.items():
        assert abs(got[cell] - tau) <= 0.01, (cell, got[cell], tau)


def test_prefill_admission_dispatches_equal_the_reference(monkeypatch):
    """Smoke width, batch 4, two bursts, sequential and bucketed."""
    monkeypatch.setattr(RefEngine, "warmup", lambda self: 0.0)
    expected = ref_admission.run(batch=4, reps=2)
    got = port_admission.run(batch=4, reps=2, device="cpu")
    for mode in ("sequential", "bucketed"):
        assert got[mode]["dispatches"] == expected[mode]["dispatches"]
        assert got[mode]["finished"] == 8
        # on the CPU the wrappers run their plain versions: no launch
        assert not any(got[mode]["launches"].values())
    assert got["bucketed"]["dispatches"] < got["sequential"]["dispatches"]
    assert got["width"] == "smoke" and got["dtype"] == "float32"


@pytest.mark.parametrize("backbone", ["bert", "opt", "t5"])
def test_pars_bert_base_width_is_the_papers_config(monkeypatch, backbone):
    """At ``pars_bert_base`` the trainer gets BERT-base's config with the
    backbone replaced and its tokenizer; at ``mini`` the defaults."""
    from repro_torch.configs.pars_bert_base import CONFIG
    seen = {}

    def fake_train(prompts, lengths, **kw):
        seen[kw["pcfg"] is None] = kw
        return FixedScorer()

    monkeypatch.setattr(port_common, "scale",
                        lambda: port_common.BenchScale(**TINY))
    monkeypatch.setattr(port_common, "train_predictor", fake_train)
    _clear_caches()
    try:
        port_common.get_predictor("alpaca", "r1", backbone=backbone,
                                  device="cpu", width="pars_bert_base")
        port_common.get_predictor("alpaca", "r1", backbone=backbone,
                                  device="cpu", width="mini")
    finally:
        _clear_caches()
    wide, mini = seen[False], seen[True]
    assert wide["pcfg"] == dataclasses.replace(CONFIG, backbone=backbone)
    assert (wide["tokenizer"].vocab_size, wide["tokenizer"].max_len) == \
        (CONFIG.vocab_size, CONFIG.max_len)
    assert mini["tokenizer"] is None and mini["backbone"] == backbone
    assert wide["settings"].delta == mini["settings"].delta == 0.25
    with pytest.raises(ValueError, match="width"):
        port_common.get_predictor("alpaca", "r1", device="cpu",
                                  width="bert_large")


def test_check_bench_gates_a_torch_run(tiny, tmp_path):
    path = tmp_path / "BENCH_torch.json"
    sections = torch_run.main(["--device", "cpu", "--smoke", "--json",
                               str(path)])
    assert set(sections) == set(torch_run.BENCHES)
    assert check_bench.check(path) == []
    data = json.loads(path.read_text())
    assert all(s["device"] == ("simulator" if name in
                               check_bench.SIMULATOR_SECTIONS else "cpu")
               for name, s in data.items())
    assert data["table2"]["predictor"] == "mini"
    assert data["prefill_admission"]["predictor"] is None
    # the CPU's sections are refused where card numbers are claimed
    assert len(check_bench.check(path, card=True)) == \
        len(data) - len(check_bench.SIMULATOR_SECTIONS)

    def broken(edit):
        d = json.loads(path.read_text())
        edit(d)
        out = tmp_path / "broken.json"
        out.write_text(json.dumps(d))
        return check_bench.check(out)

    assert broken(lambda d: d.pop("cross_model")) == \
        ["section missing: cross_model"]
    assert broken(lambda d: d["table3"].pop("device")) == \
        ["table3.device missing or null"]
    assert broken(lambda d: d["table2"].update(tau=None)) == \
        ["table2.tau missing or null"]


def test_twins_raise_without_a_card():
    """Each twin's command line, with its default device, under
    ``CUDA_VISIBLE_DEVICES=""``: CUDA is not available, and it says so."""
    mods = [f"benchmarks.{m}" for name, m in torch_run.MODULES.items()
            if name not in port_common.SERVING_BENCHES]   # no device
    mods += ["benchmarks.torch_run"]
    code = ("import runpy, sys\n"
            "for mod in sys.argv[1:]:\n"
            "    sys.argv = [mod]\n"
            "    try:\n"
            "        runpy.run_module(mod, run_name='__main__')\n"
            "    except RuntimeError as e:\n"
            "        assert 'CUDA is not available' in str(e), (mod, e)\n"
            "    else:\n"
            "        raise SystemExit(f'{mod} ran without a card')\n"
            "print('all raised')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code, *mods], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "all raised" in proc.stdout
