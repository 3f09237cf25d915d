"""Architectures are files the harness finds by name (``bench/archs``):
``lm`` gives today's weights, reference logits and work counts, and an
architecture planted in a throwaway root, with its configuration, cell and
traffic, is served and judged end to end on the CPU."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _bench_tiny as tiny  # noqa: E402

from bench.harness import cell as cell_mod, flops, serve, spec  # noqa: E402
from bench.harness import weights  # noqa: E402
from bench.reference import lm as ref_lm  # noqa: E402
from bench.reference.precision import F32  # noqa: E402

CPU = torch.device("cpu")
LM = spec.arch("lm")


def leaves(t, pre=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from leaves(v, pre + k + ".")
        else:
            yield pre + k, v


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_lm_draws_the_weights_of_make_params(family):
    cfg_json = tiny.config(family)
    ours = dict(leaves(LM.make_params(LM.program_config(cfg_json), 5, CPU)))
    theirs = dict(leaves(weights.make_params(
        serve.program_config(cfg_json), 5, CPU)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


def _case(family):
    """Reference inputs: an MoE row dispatched beside another, then a
    chunk and two decoded tokens of its own; a hybrid row as one group."""
    t = lambda x: torch.as_tensor(x, dtype=torch.long)   # noqa: E731
    if family == "moe":
        group = t([[3, 9, 27, 81, 243, 217, 139, 1], [5, 25, 125, 113, 53,
                                                       265, 301, 481]])
        return (group, 1, t([11, 12, 13, 14]),
                [(0, 2, "chunk"), (2, 3, "token"), (3, 4, "token")],
                list(range(7, 12)))
    return t([[3, 9, 27, 81, 243, 217, 139, 1, 7, 49, 343, 351]]), 0, \
        t([]), [], list(range(5, 12))


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_lm_gives_the_reference_logits(family):
    cfg_json = tiny.config(family)
    params = weights.make_params(serve.program_config(cfg_json), 5, CPU)
    group, row, own, segs, positions = _case(family)
    probe_a, probe_b = {}, {}
    a = LM.logits(params, cfg_json["model"], group, row, own, segs,
                  positions, F32, probe_a)
    b = ref_lm.logits(params, cfg_json["model"], group, row, own, segs,
                      positions, F32, probe_b)
    assert torch.equal(a, b)
    assert probe_a.keys() == probe_b.keys()
    for k in probe_a:
        assert torch.equal(probe_a[k], probe_b[k])


@pytest.mark.parametrize("config", sorted(
    p.stem for p in (spec.BENCH / "configs").glob("*.json")))
def test_work_counts_are_todays(config):
    """Useful FLOPs, and the decode bound the roofline readers sum over a
    slice's steps: the architecture's against ``flops`` times the layers,
    to rounding."""
    cfg_json = spec.load_json(spec.BENCH / "configs" / f"{config}.json")
    m = cfg_json["model"]
    arch = spec.arch(spec.arch_name(cfg_json))
    rng = np.random.default_rng(7)
    positions = rng.integers(0, 2000, 300)
    assert arch.tokens_flops(m, positions) == pytest.approx(
        flops.tokens_flops(m, positions), rel=1e-12)
    steps = [rng.integers(0, 2000, n).tolist() for n in (1, 7, 64)]
    for block in (0, 16):
        today = sum(flops.decode_bound_s(m, p, block) for p in steps) \
            * m["num_layers"]
        assert sum(arch.decode_bound_s(m, p, block) for p in steps) == \
            pytest.approx(today, rel=1e-12)


TOY = '''"""A planted architecture: the decoder LMs with the embedding drawn at
another scale, recording each call; its reference raises one vocabulary
entry's logit by the bump."""
from bench.harness import spec

LM = spec.arch("lm")
CALLS = []


def program_config(cfg_json):
    CALLS.append("program_config")
    return LM.program_config(cfg_json)


def make_params(cfg, seed, device):
    CALLS.append("make_params")
    params = LM.make_params(cfg, seed, device)
    params["embed"] = params["embed"] * 4.0
    return params


def logits(params, model, group, row, own, segments, positions, precision,
           probe=None):
    CALLS.append("logits")
    out = LM.logits(params, model, group, row, own, segments, positions,
                    precision, probe)
    out[:, out[0].topk(2).indices[1]] += {bump}
    return out


def tokens_flops(model, positions):
    CALLS.append("tokens_flops")
    return LM.tokens_flops(model, positions)


def decode_bound_s(model, positions, block=0):
    CALLS.append("decode_bound_s")
    return LM.decode_bound_s(model, positions, block)
'''


def _plant(root: Path, arch: str, toy: str = None) -> spec.Cell:
    """A root holding a tiny burst cell over a configuration that names
    ``arch``, and ``bench/archs/toy.py`` (``toy``); nothing else."""
    for d in ("configs", "traffic", "cells", "archs"):
        (root / "bench" / d).mkdir(parents=True)
    cfg = dict(tiny.config("moe", dtype="float32"), arch=arch)
    (root / "bench" / "configs" / "toy.json").write_text(json.dumps(cfg))
    (root / "bench" / "traffic" / "toy-mix.json").write_text(
        json.dumps(tiny.mix("burst")))
    (root / "bench" / "cells" / "toy-burst.json").write_text(
        json.dumps({"burst_interval_s": 1.5}))
    if toy is not None:
        (root / "bench" / "archs" / "toy.py").write_text(toy)
    cell = ["toy-burst"]
    (root / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "toy-burst", "config": "toy",
                       "traffic": "toy-mix", "chips": 1}],
        "end_to_end": [{"name": "latency_per_token_mean", "unit": "s/token",
                        "workloads": cell},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "step_mfu.burst", "unit": "%",
                       "moves": "latency_per_token_mean",
                       "workloads": cell}]}))
    return spec.find("toy-burst", root=root)


def _run(c, trace=False):
    return cell_mod.run(c, 2**33 + 9, 3.0, trace, CPU, time.perf_counter(),
                        log=lambda s: None)


def test_planted_architecture_is_found_and_served(tmp_path):
    c = _plant(tmp_path, "toy", TOY.replace("{bump}", "0.0"))
    assert c.arch is spec.arch("toy", root=tmp_path)
    assert c.arch.LM is LM
    out = _run(c, trace=True)
    assert out["result"]["correct"], out["checks"]
    assert out["readings"]["logit_gap"] == 0.0
    assert "step_mfu.burst" in out["result"]["metrics"]
    assert {"program_config", "make_params", "logits",
            "tokens_flops"} <= set(c.arch.CALLS)


def test_planted_logit_fault_is_caught(tmp_path):
    """One vocabulary entry's reference logit raised by 1.0 (the runner-up
    at the first position judged) makes the served tokens fall short of the
    reference's best."""
    c = _plant(tmp_path, "toy", TOY.replace("{bump}", "1.0"))
    out = _run(c)
    assert not out["result"]["correct"]
    gap = out["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def test_unknown_arch_fails_in_find(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match=r"bench/archs/nope\.py is missing"):
        _plant(tmp_path, "nope")
