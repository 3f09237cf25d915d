"""The port's config registry, and the dense configs it serves beyond llama.

``repro_torch.configs`` holds every architecture of the reference's
registry, field for field (published and smoke configs). The attention
families' and the encoder-decoder family's parameters have the reference's
leaves (paths, shapes, dtypes), counted from the widths alone by
``param_count``. The f32
``nemotron_4_15b`` (squared ReLU, layernorm) and ``command_r_35b``
(layernorm, tied head, rope theta 8e6) smoke configs give the JAX model's
logits at 1e-4 through prefill and decode, and nemotron's greedy tokens on
the paged engine equal the JAX ``Engine``'s per ``req_id``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.scheduler.policies import fcfs as jax_fcfs
from repro.core.scheduler.request import Request as JaxRequest
from repro.core.scheduler.scheduler import Scheduler as JaxScheduler
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JaxEngine
from repro.training.checkpoint import _flatten
from repro_torch import bridge, configs
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
DENSE_EXTRA = ["nemotron_4_15b", "command_r_35b"]
# the family the port ran last (ROADMAP A11, encoder-decoder) -> its item
UNPORTED = {"whisper_tiny": "A11"}
# the MoE and VLM configs (ROADMAP A9)
MOE_VLM = ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "kimi_k2_1t_a32b",
           "qwen2_vl_72b"]


def test_all_configs_equals_the_reference_registry():
    ref = jconfigs.all_configs()
    mine = configs.all_configs()
    assert list(mine) == list(ref) and len(mine) == 10
    for arch in ref:
        assert dataclasses.asdict(mine[arch]) == dataclasses.asdict(ref[arch])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_config_equals_the_reference(arch):
    assert dataclasses.asdict(configs.get_smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.get_smoke_config(arch))


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_families_are_refused_naming_their_item(arch):
    """The last family to be ported, the encoder-decoder (its item now
    done), is no longer refused: ``init_params`` builds the reference's
    leaves, the decoder's ``cross`` and ``ln_cross``, its learned
    ``pos_embed`` and the ``encoder`` subtree included, and ``param_count``
    counts them."""
    cfg = configs.get_smoke_config(arch)
    tfm.check_supported(cfg)
    assert not tfm.default_paged(cfg)
    ref = _flatten(jtfm.init_params(jax.random.PRNGKey(0),
                                    jconfigs.get_smoke_config(arch)))
    mine = bridge.flatten(tfm.init_params(cfg, device="cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in mine.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref.items()}
    assert {"encoder/pos_embed", "pos_embed",
            "layers/cross/wq", "layers/ln_cross/scale"} <= set(mine)
    assert tfm.param_count(cfg) == sum(v.numel() for v in mine.values())


@pytest.mark.parametrize("arch", MOE_VLM + ["llama3_2_3b"] + DENSE_EXTRA)
def test_attention_family_params_have_the_reference_leaves(arch):
    """``init_params`` builds the reference's leaves (the experts' router in
    f32 beside bf16 weights, a shared MLP only where ``d_ff > 0``, biases,
    layernorm, a tied head), and ``param_count`` counts them from the
    widths."""
    cfg = configs.get_smoke_config(arch)
    tfm.check_supported(cfg)
    assert tfm.default_paged(cfg)
    ref = _flatten(jtfm.init_params(jax.random.PRNGKey(0),
                                    jconfigs.get_smoke_config(arch)))
    mine = bridge.flatten(tfm.init_params(cfg, device="cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in mine.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref.items()}
    assert tfm.param_count(cfg) == sum(v.numel() for v in mine.values())


def test_param_count_of_the_published_moe_config():
    """olmoe_1b_7b: 419.6 M parameters a layer (attention 4 x 2048^2,
    64 experts of 3 x 2048 x 1024, a 2048 x 64 router, two norms), 6.92 B
    with the embedding and the untied head (2 x 50304 x 2048)."""
    cfg = configs.get_config("olmoe_1b_7b")
    layer = 4 * 2048 ** 2 + 64 * 3 * 2048 * 1024 + 2048 * 64 + 2 * 2048
    assert layer == 419_565_568
    assert tfm.param_count(cfg) == 16 * layer + 2 * 50304 * 2048 + 2048
    assert round(tfm.param_count(cfg) / 1e9, 2) == 6.92


def _bridged(arch):
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32",
                                                   vocab_size=2048)
    cfg = configs.get_smoke_config(arch).replace(dtype="float32",
                                                 vocab_size=2048)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, bridge.params_from_flat(_flatten(jparams),
                                                       device="cpu")


@pytest.fixture(scope="module")
def nemotron():
    return _bridged("nemotron_4_15b")


@pytest.mark.parametrize("arch", DENSE_EXTRA)
def test_dense_config_logits_match(arch):
    """Prefill 20 tokens into a paged cache, then decode 3: every stage's
    logits match the reference's."""
    jcfg, jparams, cfg, params = _bridged(arch)
    tfm.check_supported(cfg)
    assert ("lm_head" in params) != cfg.tie_embeddings
    toks = np.random.default_rng(7).integers(0, 2048, (2, 23), np.int32)
    jl, jcache, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks[:, :20]),
                                     build_cache=True, cache_len=32,
                                     remat="none")
    cache = tfm.init_cache(cfg, 2, 32, device="cpu")
    lg, cache, _ = tfm.forward_seq(params, cfg,
                                   torch.from_numpy(toks[:, :20]).long(),
                                   cache=cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for t in range(20, 23):
        jl, jcache = jtfm.decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        lg, cache, _ = tfm.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def _words(n, tag):
    return " ".join(f"{tag}w{j}" for j in range(n))


def test_nemotron_paged_engine_tokens_match_jax_engine(nemotron):
    jcfg, jparams, cfg, params = nemotron

    def run(port):
        req = Request if port else JaxRequest
        reqs = [req(i, _words(5 + 7 * i, f"n{i}"), 0.0, 32, 4 + 3 * i)
                for i in range(4)]
        if port:
            eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=2),
                         cache_len=64, prompt_len=32, record_tokens=True,
                         device="cpu")
        else:
            eng = JaxEngine(jcfg, jparams,
                            JaxScheduler(policy=jax_fcfs(), max_batch=2),
                            cache_len=64, prompt_len=32, record_tokens=True)
        eng.submit(reqs)
        return {r.req_id: r.generated_tokens for r in eng.run()}, eng

    ref, jeng = run(False)
    out, eng = run(True)
    assert eng.backend.paged and jeng.backend.paged
    assert out == ref and len(out) == 4
    assert eng.allocator.used_blocks == 0
