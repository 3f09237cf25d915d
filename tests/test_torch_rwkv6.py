"""The port's RWKV-6 (SSM family) against the JAX reference.

The f32 ``rwkv6_7b`` smoke config, weights bridged from
``tfm.init_params(PRNGKey(0), cfg)``, JAX at "highest" matmul precision:
the per-head group norm, time-mix and channel-mix in sequence and step
form, ``forward_seq`` logits and the decode state it builds, prefill then
decode against one full forward, and the engine's greedy tokens per
``req_id`` against the JAX ``Engine`` (contiguous state, slots reused),
with the reference's refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.scheduler.policies import make_policy as jax_make_policy
from repro.core.scheduler.request import Request as JaxRequest
from repro.core.scheduler.scheduler import Scheduler as JaxScheduler
from repro.models import common as jcommon
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JaxEngine
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.bridge import flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.scheduler.policies import fcfs, make_policy
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.models import common, rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def rwkv():
    jcfg = jax_smoke_config("rwkv6_7b").replace(dtype="float32",
                                                vocab_size=2048)
    cfg = get_smoke_config("rwkv6_7b").replace(dtype="float32",
                                               vocab_size=2048)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(b, s, seed=0, vocab=2048):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _layer(jparams, params, i=0):
    """Layer ``i``'s time-mix and channel-mix parameters, both frameworks,
    with random (not init-constant) decay base, bonus, norm scale and
    shift lerps, so that every term of the recurrence counts."""
    rng = np.random.default_rng(10 + i)
    out = {}
    for part in ("tm", "cm"):
        jp = {k: np.asarray(v[i]) for k, v in jparams["layers"][part].items()}
        for k in ("mix", "decay_base", "bonus", "gn_scale"):
            if k in jp:
                jp[k] = (jp[k] + rng.standard_normal(jp[k].shape) * 0.3
                         ).astype(np.float32)
        out[part] = ({k: jnp.asarray(v) for k, v in jp.items()},
                     {k: torch.from_numpy(v.copy()) for k, v in jp.items()})
    return out


def test_init_params_match_the_reference_tree(rwkv):
    """The port's own init has the reference's leaves, shapes and dtypes:
    no attention or MLP, the decay adapter, bonus and norm scale f32 in a
    bf16 model."""
    jcfg, jparams, cfg, _ = rwkv
    ref = _flatten(jparams)
    mine = flatten(tfm.init_params(cfg, device="cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: v.shape for k, v in ref.items()}
    bf = flatten(tfm.init_params(cfg.replace(dtype="bfloat16"),
                                 device="cpu"))
    f32 = {k for k, v in bf.items() if v.dtype == torch.float32}
    assert f32 == {f"layers/tm/{k}" for k in ("decay_base", "decay_a",
                                              "decay_b", "bonus",
                                              "gn_scale")}


def test_group_norm_heads_matches():
    x = np.random.default_rng(1).standard_normal((2, 5, 4, 64), np.float32)
    scale = np.random.default_rng(2).standard_normal((4, 64), np.float32)
    ref = jcommon.group_norm_heads(jnp.asarray(x), jnp.asarray(scale))
    out = common.group_norm_heads(torch.from_numpy(x), torch.from_numpy(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("fn", ["time_mix-32", "time_mix-40", "time_mix_step",
                                "channel_mix", "channel_mix_step"])
def test_time_and_channel_mix_match(rwkv, fn):
    """Sequence forms at T=32 (one chunk) and T=40 (the wrapper pads to
    64; the reference chunks at 40), and one-token forms from a random
    state and shift."""
    jcfg, jparams, cfg, params = rwkv
    lp = _layer(jparams, params)
    rng = np.random.default_rng(3)
    name, _, t = fn.partition("-")
    b, d = 2, cfg.d_model
    prev = rng.standard_normal((b, d), np.float32)
    if name == "time_mix":
        x = rng.standard_normal((b, int(t), d), np.float32)
        ref = jrwkv.time_mix(lp["tm"][0], jnp.asarray(x), jnp.asarray(prev),
                             jcfg)
        out = rwkv6.time_mix(lp["tm"][1], torch.from_numpy(x),
                             torch.from_numpy(prev), cfg)
    elif name == "time_mix_step":
        x = rng.standard_normal((b, d), np.float32)
        h, dh = cfg.num_heads, cfg.head_dim
        state = rng.standard_normal((b, h, dh, dh), np.float32)
        ref = jrwkv.time_mix_step(lp["tm"][0], jnp.asarray(x),
                                  jnp.asarray(prev), jnp.asarray(state), jcfg)
        out = rwkv6.time_mix_step(lp["tm"][1], torch.from_numpy(x),
                                  torch.from_numpy(prev),
                                  torch.from_numpy(state), cfg)
    else:
        shape = (b, 24, d) if name == "channel_mix" else (b, d)
        x = rng.standard_normal(shape, np.float32)
        ref = getattr(jrwkv, name)(lp["cm"][0], jnp.asarray(x),
                                   jnp.asarray(prev))
        out = getattr(rwkv6, name)(lp["cm"][1], torch.from_numpy(x),
                                   torch.from_numpy(prev))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **STEP_TOL)


def test_forward_seq_logits_and_cache_match(rwkv):
    jcfg, jparams, cfg, params = rwkv
    toks = _tokens(2, 32, seed=4)
    jl, jcache, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks),
                                     build_cache=True, cache_len=32,
                                     remat="none")
    lg, cache, _ = tfm.forward_seq(params, cfg, torch.from_numpy(toks).long(),
                                   build_cache=True, cache_len=32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert "k" not in cache and "v" not in cache
    for key in ("state", "tm_prev", "cm_prev"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    assert cache["state"].dtype == torch.float32
    assert cache["pos"].tolist() == [32, 32]


def test_prefill_then_decode_equals_full_forward(rwkv):
    """Prefill 28 tokens, decode 4 (tests/test_arch_smoke.py's check): each
    step equals the full forward's logits at its position, and the
    reference's decode logits."""
    jcfg, jparams, cfg, params = rwkv
    toks = _tokens(2, 32, seed=5)
    full, _, _ = tfm.forward_seq(params, cfg, torch.from_numpy(toks).long())
    _, cache, _ = tfm.forward_seq(params, cfg,
                                  torch.from_numpy(toks[:, :28]).long(),
                                  build_cache=True, cache_len=32)
    _, jcache, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks[:, :28]),
                                    build_cache=True, cache_len=32,
                                    remat="none")
    for t in range(28, 32):
        step = torch.from_numpy(toks[:, t:t + 1]).long()
        lg, cache, _ = tfm.decode_step(params, cfg, cache, step)
        jl, jcache = jtfm.decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=2e-4,
                                   rtol=2e-3)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert cache["pos"].tolist() == [32, 32]


def _words(n, tag):
    return " ".join(f"{tag}w{j}" for j in range(n))


def _workload(req_cls):
    """Five prompts of 6-30 words (buckets 8, 16 and 32) for two slots:
    every slot serves more than one request."""
    return [req_cls(i, _words(6 + 6 * i, f"u{i}"), 0.0, 32, 3 + 2 * i)
            for i in range(5)]


def _scorer(prompts):
    """A fixed ranking for both engines: longer prompts first."""
    return np.asarray([-len(p) for p in prompts], np.float32)


def _serve(port, rwkv, policy, reqs, max_batch=2):
    jcfg, jparams, cfg, params = rwkv
    if port:
        pol = fcfs() if policy == "fcfs" else make_policy("pars", _scorer)
        eng = Engine(cfg, params, Scheduler(policy=pol, max_batch=max_batch),
                     cache_len=64, prompt_len=32, record_tokens=True,
                     device="cpu")
    else:
        pol = jax_make_policy(policy, _scorer if policy == "pars" else None)
        eng = JaxEngine(jcfg, jparams,
                        JaxScheduler(policy=pol, max_batch=max_batch),
                        cache_len=64, prompt_len=32, record_tokens=True)
    eng.submit(reqs)
    fin = eng.run()
    return {r.req_id: r.generated_tokens for r in fin}, eng


@pytest.mark.parametrize("policy", ["fcfs", "pars"])
def test_engine_tokens_match_jax_engine(rwkv, policy):
    ref, jeng = _serve(False, rwkv, policy, _workload(JaxRequest))
    out, eng = _serve(True, rwkv, policy, _workload(Request))
    assert not eng.backend.paged and "k" not in eng.backend.lanes
    assert out == ref
    assert len(out) == 5 and all(len(t) == 3 + 2 * i
                                 for i, t in out.items())
    assert eng.backend.prefill_dispatches == jeng.backend.prefill_dispatches
    assert eng.allocator.used_blocks == 0


def test_a_reused_slot_starts_clean(rwkv):
    """One slot: the second request's tokens equal its tokens in a fresh
    engine, so nothing of the first occupant's state leaks."""
    reqs = [Request(0, _words(20, "first"), 0.0, 32, 6),
            Request(1, _words(9, "second"), 0.0, 32, 6)]
    both, _ = _serve(True, rwkv, "fcfs", reqs, max_batch=1)
    alone, _ = _serve(True, rwkv, "fcfs",
                      [Request(1, _words(9, "second"), 0.0, 32, 6)],
                      max_batch=1)
    assert both[1] == alone[1]


@pytest.mark.parametrize("kw", [dict(prefill_chunk_tokens=8),
                                dict(prefix_caching=True),
                                dict(paged=True)],
                         ids=["chunked", "prefix_caching", "paged"])
def test_engine_refuses_what_the_reference_refuses(rwkv, kw):
    """tests/test_chunked_prefill.py, test_prefix_caching.py and
    test_paged_decode.py: the recurrent family refuses each, with the
    reference's words."""
    jcfg, jparams, cfg, params = rwkv
    with pytest.raises(ValueError, match="attention-family"):
        JaxEngine(jcfg, jparams, JaxScheduler(policy=jax_make_policy("fcfs"),
                                              max_batch=2),
                  cache_len=64, prompt_len=16, **kw)
    with pytest.raises(ValueError, match="attention-family"):
        Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=2),
               cache_len=64, prompt_len=16, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="attention-family"):
        tfm.forward_chunk(params, cfg, torch.zeros(1, 4, dtype=torch.long),
                          tfm.init_cache(cfg, 1, 16, device="cpu"))
