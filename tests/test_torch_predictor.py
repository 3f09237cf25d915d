"""The port's ranking predictor against the JAX reference.

Scores of the bert, opt and t5 heads on bridged parameters are allclose,
a checkpoint written by the reference's ``RankingPredictor.save`` loads in
the port without JAX and one the port saves loads in the reference, and the
PARS admission order on a burst is the same. Training: the same pairs from
the same seed, and each method's trajectory from bridged initial
parameters (per-epoch mean losses, final scores, Kendall tau).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.predictor import train as jtrain
from repro.core.predictor.backbones import PredictorConfig as JaxPCfg
from repro.core.predictor.backbones import init_predictor as jax_init
from repro.core.predictor.backbones import predictor_forward as jax_forward
from repro.core.predictor.pairing import build_pairs as jax_build_pairs
from repro.core.predictor.tokenizer import HashTokenizer as JaxTokenizer
from repro.core.predictor.train import RankingPredictor as JaxPredictor
from repro.core.scheduler.policies import make_policy as jax_make_policy
from repro.core.scheduler.scheduler import Scheduler as JaxScheduler
from repro.data.synthetic import make_corpus as jax_make_corpus
from repro.data.synthetic import sample_lengths
from repro.data.workload import burst_arrivals as jax_burst
from repro.data.workload import make_requests as jax_make_requests
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.core.predictor import (HashTokenizer, PredictorConfig,
                                        RankingPredictor, TrainSettings,
                                        build_pairs, evaluate_tau,
                                        init_predictor, predictor_forward,
                                        train_predictor)
from repro_torch.core.predictor import train as port_train
from repro_torch.core.scheduler.policies import make_policy
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.data.synthetic import make_corpus
from repro_torch.data.workload import burst_arrivals, make_requests

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
SIZES = dict(vocab_size=512, max_len=24, d_model=32, num_heads=4,
             num_layers=2, d_ff=64)


def _tokens(n=6, seed=0):
    """PAD-padded rows of assorted lengths, [CLS] first, as encode_batch."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, SIZES["max_len"]), np.int32)
    for i in range(n):
        m = int(rng.integers(2, SIZES["max_len"] + 1))
        toks[i, 0] = 1
        toks[i, 1:m] = rng.integers(3, SIZES["vocab_size"], m - 1)
    return toks


@pytest.mark.parametrize("backbone", ["bert", "opt", "t5"])
def test_predictor_scores_match(backbone):
    jparams = jax_init(jax.random.PRNGKey(3), JaxPCfg(backbone=backbone,
                                                      **SIZES))
    cfg = PredictorConfig(backbone=backbone, **SIZES)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    toks = _tokens()
    ref = jax_forward(jparams, JaxPCfg(backbone=backbone, **SIZES), toks)
    out = predictor_forward(params, cfg, torch.from_numpy(toks).long())
    assert out.dtype == torch.float32 and out.shape == (len(toks),)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("backbone", ["bert", "t5"])
def test_port_init_matches_reference_layout(backbone):
    """Seeded port parameters carry the reference's tree paths and shapes,
    so checkpoints and bridged trees are interchangeable."""
    jparams = jax_init(jax.random.PRNGKey(0), JaxPCfg(backbone=backbone,
                                                      **SIZES))
    params = init_predictor(PredictorConfig(backbone=backbone, **SIZES),
                            device="cpu")
    ref = bridge.unflatten({k: tuple(v.shape)
                            for k, v in _flatten(jparams).items()})

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(params) == ref


def test_predictor_checkpoint_from_reference_loads(tmp_path):
    cfg = JaxPCfg(backbone="bert", **SIZES)
    jpred = JaxPredictor(cfg=cfg, params=jax_init(jax.random.PRNGKey(5), cfg),
                         tokenizer=JaxTokenizer(SIZES["vocab_size"],
                                                SIZES["max_len"]),
                         method="pairwise")
    path = str(tmp_path / "pred.npz")
    jpred.save(path)
    pred = RankingPredictor.load(path, device="cpu")
    assert pred.cfg == PredictorConfig(backbone="bert", **SIZES)
    assert pred.method == "pairwise"
    prompts = jax_make_corpus("alpaca", 12, seed=3).prompts
    np.testing.assert_allclose(pred.score(prompts), jpred.score(prompts),
                               **TOL)


def test_pars_admission_order_matches_on_a_burst():
    cfg = JaxPCfg(backbone="bert", **SIZES)
    jparams = jax_init(jax.random.PRNGKey(7), cfg)
    tok = JaxTokenizer(SIZES["vocab_size"], SIZES["max_len"])
    jpred = JaxPredictor(cfg=cfg, params=jparams, tokenizer=tok)
    pred = RankingPredictor(
        cfg=PredictorConfig(backbone="bert", **SIZES),
        params=bridge.params_from_flat(_flatten(jparams), device="cpu"),
        tokenizer=HashTokenizer(SIZES["vocab_size"], SIZES["max_len"]))
    n = 16
    lengths = np.arange(1, n + 1)
    jsched = JaxScheduler(policy=jax_make_policy("pars", jpred), max_batch=n)
    jsched.add_requests(jax_make_requests(jax_make_corpus("alpaca", n, 4),
                                          lengths, jax_burst(n)))
    sched = Scheduler(policy=make_policy("pars", pred), max_batch=n)
    sched.add_requests(make_requests(make_corpus("alpaca", n, 4), lengths,
                                     burst_arrivals(n)))
    order = [r.req_id for r in sched.schedule(0.0)]
    assert order == [r.req_id for r in jsched.schedule(0.0)]
    assert order != list(range(n))            # the ranking did reorder
    assert sched.policy.scorer_failures == 0


def test_port_checkpoint_loads_in_reference(tmp_path):
    cfg = PredictorConfig(backbone="opt", **SIZES)
    pred = RankingPredictor.init(cfg, 4, device="cpu")
    pred.method = "listwise"
    path = str(tmp_path / "port.npz")
    pred.save(path)
    jpred = JaxPredictor.load(path)
    assert jpred.cfg == JaxPCfg(backbone="opt", **SIZES)
    assert jpred.method == "listwise"
    prompts = jax_make_corpus("alpaca", 12, seed=3).prompts
    np.testing.assert_allclose(jpred.score(prompts), pred.score(prompts),
                               atol=1e-6, rtol=1e-6)


def test_build_pairs_same_pairs_from_the_same_seed():
    lengths = np.random.default_rng(0).integers(1, 300, 200).astype(np.float32)
    for delta in (0.0, 0.2, 0.25):
        got = build_pairs(lengths, np.random.default_rng(7), n_pairs=300,
                          delta=delta)
        ref = jax_build_pairs(lengths, np.random.default_rng(7), n_pairs=300,
                              delta=delta)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


class _MeanSpy:
    """Stands in for a training module's ``np``: records each ``np.mean``
    (the per-epoch mean loss of its log line) and passes the rest through."""

    def __init__(self):
        self.means = []

    def __getattr__(self, name):
        return getattr(np, name)

    def mean(self, x, *args, **kwargs):
        m = np.mean(x, *args, **kwargs)
        self.means.append(float(m))
        return m


@pytest.mark.parametrize("method", ["pairwise", "pointwise", "listwise"])
def test_train_predictor_matches_reference(monkeypatch, method):
    """The mini predictor (``PredictorConfig()``) trained two epochs on 200
    prompts (batch 32; 256 pairs an epoch) by both frameworks from the same
    bridged initial parameters and seed: per-epoch mean losses within 1e-4
    relative, held-out scores within 1e-3, Kendall tau within 0.01."""
    c = jax_make_corpus("alpaca", 200, seed=0)
    lengths = sample_lengths(c, "gpt4")
    held = jax_make_corpus("alpaca", 60, seed=42)
    held_lengths = sample_lengths(held, "gpt4", run_seed=9)
    st = dict(method=method, epochs=2, batch_size=32, pairs_per_epoch=256)
    jparams = jax_init(jax.random.PRNGKey(0), JaxPCfg())
    monkeypatch.setattr(
        port_train, "init_predictor", lambda cfg, seed=0, *, device="cuda":
        bridge.params_from_flat(_flatten(jparams), device=device))
    spies = _MeanSpy(), _MeanSpy()
    monkeypatch.setattr(jtrain, "np", spies[0])
    monkeypatch.setattr(port_train, "np", spies[1])
    jpred = jtrain.train_predictor(c.prompts, lengths,
                                   settings=jtrain.TrainSettings(**st),
                                   log_fn=lambda msg: None)
    pred = train_predictor(c.prompts, lengths, settings=TrainSettings(**st),
                           log_fn=lambda msg: None, device="cpu")
    monkeypatch.undo()
    assert len(spies[1].means) == len(spies[0].means) == 2
    np.testing.assert_allclose(spies[1].means, spies[0].means, rtol=1e-4)
    np.testing.assert_allclose(pred.score(held.prompts),
                               jpred.score(held.prompts), atol=1e-3)
    tau = evaluate_tau(pred, held.prompts, held_lengths)
    assert abs(tau - jtrain.evaluate_tau(jpred, held.prompts,
                                         held_lengths)) <= 0.01
