"""The port's sampler against the JAX reference: greedy picks the same
tokens, and top-k / top-p keep the same support (draws are compared by the
kept set, since the two frameworks' random streams differ)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampler import SamplerConfig as JaxSamplerConfig
from repro.serving.sampler import sample as jax_sample
from repro_torch.serving.sampler import SamplerConfig, filter_logits, sample

torch.set_num_threads(1)


def test_greedy_matches_reference_argmax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    logits[2, [3, 9]] = 10.0                  # a tie: first index wins
    ref = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0))
    out = sample(torch.from_numpy(logits))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out[2]) == 3


def _jax_support(logits, cfg, draws=2000):
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    got = jax.vmap(lambda k: jax_sample(jnp.asarray(logits), k, cfg))(keys)
    return set(np.asarray(got).tolist())


@pytest.mark.parametrize("logits,kw", [
    ([0.0, 1.0, 2.0, 3.0], dict(top_k=2)),
    ([10.0, 9.9, -10.0, -10.0], dict(top_p=0.9)),
    ([1.0, 0.8, 0.6, 0.4, 0.2, 0.0, -3.0, -9.0], dict(top_p=0.7)),
    ([1.0, 0.8, 0.6, 0.4, 0.2, 0.0, -3.0, -9.0], dict(top_k=5, top_p=0.8)),
])
def test_kept_set_matches_reference(logits, kw):
    logits = np.asarray(logits, np.float32)
    kept = torch.isfinite(filter_logits(torch.from_numpy(logits),
                                        SamplerConfig(temperature=1.0, **kw)))
    port_set = set(np.flatnonzero(kept.numpy()).tolist())
    assert port_set == _jax_support(logits,
                                    JaxSamplerConfig(temperature=1.0, **kw))
    gen = torch.Generator().manual_seed(0)
    draws = sample(torch.from_numpy(np.tile(logits, (256, 1))), gen,
                   SamplerConfig(temperature=1.0, **kw))
    assert set(draws.tolist()) <= port_set


def test_temperature_sampling_matches_distribution_roughly():
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1]])).expand(4000, 3)
    gen = torch.Generator().manual_seed(0)
    draws = sample(logits, gen, SamplerConfig(temperature=1.0))
    assert 0.6 < float((draws == 0).float().mean()) < 0.8
