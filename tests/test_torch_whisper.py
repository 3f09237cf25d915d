"""Whisper (the encoder-decoder family) on the port against the JAX reference.

The f32 ``whisper_tiny`` smoke config from bridged reference parameters
(encoder subtree included), JAX at "highest" matmul precision, logits at
1e-4: ``encode`` on both routes (the prefill kernel's plain version without
the causal mask, and the plain attention), ``forward_seq`` with frames,
``build(cfg).prefill`` plus decode steps against the JAX bundle and against
the full forward (as the reference's ``test_arch_smoke`` checks), the
learned positions' modular wrap at 8,190-8,193, and the engine's refusal of
the family with the reference's reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.models import transformer as jtfm
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.models import build
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def whisper():
    jcfg = jax_smoke_config("whisper_tiny").replace(dtype="float32")
    cfg = get_smoke_config("whisper_tiny").replace(dtype="float32")
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _inputs(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = (rng.standard_normal((b, cfg.encoder_seq_len, cfg.d_model))
              * 0.02).astype(np.float32)
    return toks, frames


def _t(x):
    return torch.from_numpy(np.array(x))


def test_whisper_tiny_widths_and_leaves(whisper):
    """The published config's widths, and the bridged tree carries the
    reference's encoder leaves."""
    cfg = get_config("whisper_tiny")
    assert (cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.encoder_seq_len) == (4, 4, 384, 6, 6, 64, 1536, 51865, 1500)
    _jcfg, jparams, _cfg, params = whisper
    flat = bridge.flatten(params)
    assert set(flat) == set(_flatten(jparams))
    assert flat["encoder/layers/attn/wq"].shape[0] == _cfg.encoder_layers
    assert flat["pos_embed"].shape == (tfm.LEARNED_POSITIONS, _cfg.d_model)
    assert not tfm.default_paged(cfg)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_encode_matches_reference(whisper, impl):
    jcfg, jparams, cfg, params = whisper
    _, frames = _inputs(cfg)
    ref = jtfm.encode(jparams, jcfg, jnp.asarray(frames))
    out = tfm.encode(params, cfg, _t(frames), attn_impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
def test_forward_seq_with_frames_matches_reference(whisper, impl):
    jcfg, jparams, cfg, params = whisper
    toks, frames = _inputs(cfg)
    ref, _, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks),
                                 frames=jnp.asarray(frames), remat="none")
    out, _, _ = tfm.forward_seq(params, cfg, _t(toks).long(),
                                frames=_t(frames), attn_impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="frames"):
        tfm.forward_seq(params, cfg, _t(toks).long(), attn_impl=impl)


def test_bundle_prefill_and_decode_match_reference(whisper):
    """``build(cfg).prefill`` (the kernels' plain versions here) and four
    greedy ``decode_step``s against the JAX bundle: logits at 1e-4, the
    same greedy tokens, the cross lanes holding the reference's encoder
    K/V; and each decode step's logits equal the full forward's at that
    position (``test_arch_smoke``'s check)."""
    jcfg, jparams, cfg, params = whisper
    toks, frames = _inputs(cfg, s=32, seed=1)
    jb, tb = jmodel.build(jcfg, remat="none"), build(cfg, remat="none")
    jl, jc = jb.prefill(jparams, jnp.asarray(toks[:, :28]), 32,
                        frames=jnp.asarray(frames))
    logits, cache = tb.prefill(params, _t(toks[:, :28]).long(), 32,
                               frames=_t(frames))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert cache["pos"].tolist() == [28, 28]
    assert cache["cross_k"].shape == (cfg.num_layers, 2, cfg.num_kv_heads,
                                      cfg.encoder_seq_len, cfg.head_dim)
    np.testing.assert_allclose(cache["cross_k"].transpose(2, 3).numpy(),
                               np.asarray(jc["cross_k"]), **TOL)
    full, _, _ = tfm.forward_seq(params, cfg, _t(toks).long(),
                                 frames=_t(frames))
    jtok = tok = jnp.asarray(toks[:, 28:29])
    tok = _t(toks[:, 28:29]).long()
    for t in range(28, 32):
        jstep, jc = jb.decode_step(jparams, jc, jtok)
        step, cache = tb.decode_step(params, cache, tok)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)
        np.testing.assert_allclose(step.numpy(), full[:, t].numpy(),
                                   atol=2e-4, rtol=2e-3)
        assert step.argmax(-1).tolist() == np.asarray(
            jstep.argmax(-1)).tolist()
        if t < 31:   # teacher-forced, so the full forward covers each step
            jtok = jnp.asarray(toks[:, t + 1:t + 2])
            tok = _t(toks[:, t + 1:t + 2]).long()
    assert cache["pos"].tolist() == [32, 32]


@pytest.mark.parametrize("start", [8190, 8191, 8192, 8193])
def test_learned_positions_wrap_like_the_reference(whisper, start):
    """Table rows ``(start + i) mod 8192``: the embedding of a 4-token chunk
    at ``start`` and one decode step at ``pos = start`` from a positioned
    empty cache equal the reference's."""
    jcfg, jparams, cfg, params = whisper
    toks, frames = _inputs(cfg, b=1, s=4, seed=2)
    ref = jtfm._embed(jparams, jcfg, jnp.asarray(toks), start_pos=start)
    out = tfm._embed(params, cfg, _t(toks).long(), start)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)
    jcache = jtfm.init_cache(jcfg, 1, 16, pos=start)
    jlogits, _ = jtfm.decode_step(jparams, jcfg, jcache,
                                  jnp.asarray(toks[:, :1]))
    cache = build(cfg).init_cache(1, 16, pos=start, device="cpu")
    logits, cache, _ = tfm.decode_step(params, cfg, cache,
                                       _t(toks[:, :1]).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache["pos"].tolist() == [start + 1]


def test_engine_refuses_the_audio_family_with_the_references_reason(whisper):
    """The reference's engine cannot serve Whisper (its prefill passes no
    frames), so the port's refuses it and says why."""
    _jcfg, _jparams, cfg, params = whisper
    with pytest.raises(NotImplementedError, match="without frames"):
        Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=2),
               device="cpu")
