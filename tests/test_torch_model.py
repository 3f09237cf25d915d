"""The port's decoders against the JAX reference on bridged weights.

The f32 ``llama3_2_3b`` and ``hymba_1_5b`` smoke configs, with JAX at
"highest" matmul precision: ``forward_seq``, ``forward_chunk`` and
``decode_step`` logits are allclose at 1e-4 (Hymba's decode across a
wrapped ring included), chunked prefill equals one full forward, Hymba's
SSM at its full widths equals the reference's, and the bridge reads the
reference's checkpoints (bf16 leaves included) without JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import SSMConfig
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.training.checkpoint import _flatten, save_checkpoint
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                   vocab_size=2048)
    cfg = get_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                  vocab_size=2048)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def hymba():
    jcfg = jax_smoke_config("hymba_1_5b").replace(dtype="float32")
    cfg = get_smoke_config("hymba_1_5b").replace(dtype="float32")
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(b, s, seed=0, vocab=2048):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), np.int32)


def _lane_cache(cfg, jcache, b, w):
    """A port cache holding the reference's contiguous lanes (identity
    tables), for continuing from a JAX-built cache."""
    cache = tfm.init_cache(cfg, b, w, device="cpu")
    k = torch.from_numpy(np.array(jcache["k"]))       # (L, B, W, KH, dh)
    v = torch.from_numpy(np.array(jcache["v"]))
    bs = cache["k"].shape[2]
    n = b * (w // bs)
    cache["k"][:, :n] = k.reshape(cfg.num_layers, n, bs, *k.shape[3:])
    cache["v"][:, :n] = v.reshape(cfg.num_layers, n, bs, *v.shape[3:])
    cache["pos"][:] = int(jcache["pos"])
    return cache


def test_bridge_keeps_tree_paths_shapes_and_values(model):
    _jcfg, jparams, cfg, params = model
    flat = _flatten(jparams)
    assert params["layers"]["attn"]["wq"].shape == (
        cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    for key, arr in flat.items():
        node = params
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node.numpy(), arr)


def test_forward_seq_logits_match(model):
    jcfg, jparams, cfg, params = model
    toks = _tokens(2, 24)
    jl, _, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks), remat="none")
    lg, _, _ = tfm.forward_seq(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_forward_chunk_and_decode_step_logits_match(model):
    """Prefill 16 tokens, continue with an 8-token chunk, then decode two
    tokens: each stage's logits match the reference's."""
    jcfg, jparams, cfg, params = model
    b, w = 2, 48
    toks = _tokens(b, 26, seed=1)
    _, jcache, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks[:, :16]),
                                    build_cache=True, cache_len=w,
                                    remat="none")
    jl, jcache = jtfm.forward_chunk(jparams, jcfg, jnp.asarray(toks[:, 16:24]),
                                    jcache)
    cache = tfm.init_cache(cfg, b, w, device="cpu")
    _, cache, _ = tfm.forward_seq(params, cfg,
                                  torch.from_numpy(toks[:, :16]).long(),
                                  cache=cache)
    lg, cache, _ = tfm.forward_chunk(params, cfg,
                                     torch.from_numpy(toks[:, 16:24]).long(),
                                     cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for t in (24, 25):
        jl, jcache = jtfm.decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        lg, cache, _ = tfm.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert cache["pos"].tolist() == [26, 26]


def test_forward_chunk_per_row_offsets_match_reference_rows(model):
    """One port call continues two rows at different offsets; the reference
    needs one call per row (scalar ``pos``)."""
    jcfg, jparams, cfg, params = model
    w, c = 48, 8
    toks = _tokens(2, 40, seed=2)
    starts = [16, 24]
    cache = tfm.init_cache(cfg, 2, w, device="cpu")
    for row, s in enumerate(starts):
        sub = {**cache, "tables": cache["tables"][row:row + 1],
               "pos": cache["pos"][row:row + 1]}
        tfm.forward_seq(params, cfg, torch.from_numpy(toks[row:row + 1, :s])
                        .long(), cache=sub)
    cache["pos"] = torch.tensor(starts, dtype=torch.int32)
    chunk = np.stack([toks[r, s:s + c] for r, s in enumerate(starts)])
    lg, cache, _ = tfm.forward_chunk(params, cfg,
                                     torch.from_numpy(chunk).long(), cache)
    for row, s in enumerate(starts):
        _, jc, _ = jtfm.forward_seq(jparams, jcfg,
                                    jnp.asarray(toks[row:row + 1, :s]),
                                    build_cache=True, cache_len=w,
                                    remat="none")
        jl, _ = jtfm.forward_chunk(jparams, jcfg,
                                   jnp.asarray(chunk[row:row + 1]), jc)
        np.testing.assert_allclose(lg[row].numpy(), np.asarray(jl)[0], **TOL)
    assert cache["pos"].tolist() == [s + c for s in starts]


def test_two_chunks_equal_one_forward_seq(model):
    _jcfg, _jparams, cfg, params = model
    toks = torch.from_numpy(_tokens(2, 32, seed=3)).long()
    full, fcache, _ = tfm.forward_seq(params, cfg, toks, build_cache=True,
                                      cache_len=64)
    cache = tfm.init_cache(cfg, 2, 64, device="cpu")
    l1, cache, _ = tfm.forward_chunk(params, cfg, toks[:, :16], cache)
    l2, cache, _ = tfm.forward_chunk(params, cfg, toks[:, 16:], cache)
    torch.testing.assert_close(torch.cat([l1, l2], 1), full, **TOL)
    torch.testing.assert_close(cache["k"], fcache["k"], **TOL)
    d1, _, _ = tfm.decode_step(params, cfg, fcache, toks[:, :1])
    d2, _, _ = tfm.decode_step(params, cfg, cache, toks[:, :1])
    torch.testing.assert_close(d1, d2, **TOL)


def test_decode_past_the_lane_wraps_like_the_reference_ring(model):
    """A decode at pos >= W overwrites the row's oldest block row and
    attends the whole lane: the reference's ring-buffer semantics."""
    jcfg, jparams, cfg, params = model
    w = 16
    toks = _tokens(1, w + 2, seed=4)
    _, jcache, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks[:, :w]),
                                    build_cache=True, cache_len=w,
                                    remat="none")
    cache = _lane_cache(cfg, jcache, 1, w)
    for t in (w, w + 1):
        jl, jcache = jtfm.decode_step(jparams, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        lg, cache, _ = tfm.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_hymba_forward_seq_logits_match(hymba):
    jcfg, jparams, cfg, params = hymba
    toks = _tokens(2, 64, seed=5, vocab=cfg.vocab_size)
    jl, _, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks), remat="none")
    lg, _, _ = tfm.forward_seq(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_hymba_prefill_then_decode_over_a_wrapped_ring(hymba):
    """Prefill 32 tokens into 64-row lanes (the window), then decode 40
    more: past position 63 the lane wraps, and every step's logits, and
    the final conv tail and SSM state, match the reference's."""
    jcfg, jparams, cfg, params = hymba
    w, t_end = 64, 72
    toks = _tokens(2, t_end, seed=6, vocab=cfg.vocab_size)
    _, jcache, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(toks[:, :32]),
                                    build_cache=True, cache_len=w,
                                    remat="none")
    _, cache, _ = tfm.forward_seq(params, cfg,
                                  torch.from_numpy(toks[:, :32]).long(),
                                  build_cache=True, cache_len=w)
    assert "slots" in cache and cache["k"].shape[3] == w
    jstep = jax.jit(lambda c, t: jtfm.decode_step(jparams, jcfg, c, t))
    for t in range(32, t_end):
        jl, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]))
        lg, cache, _ = tfm.decode_step(
            params, cfg, cache, torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert cache["pos"].tolist() == [t_end, t_end]
    for leaf in ("conv_tail", "ssm_state"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), **TOL)


def test_hymba_ssm_at_full_widths_matches_reference_at_chunk_64():
    """One SSM layer at Hymba's published widths (d_inner 3200, 50 heads,
    state 16) over T=128. The port scans in chunks of 64 (the published 128
    breaks the scan's decay contract); the reference, run at chunk 64, gives
    the same outputs, conv tail and state."""
    jcfg = get_config("hymba_1_5b").replace(dtype="float32")
    cfg64 = jcfg.replace(ssm=SSMConfig(state_size=16, conv_width=4, expand=2,
                                       head_dim=64, chunk_size=64))
    jp = jssm.init_ssm(jax.random.PRNGKey(3), jcfg, jnp.float32)
    p = bridge.params_from_flat(_flatten(jp), device="cpu")
    x = np.random.default_rng(7).standard_normal((1, 128, 1600),
                                                 np.float32)
    ry, rtail, rstate = jssm.apply_ssm(jp, jnp.asarray(x), cfg64)
    y, tail, state = ssm.apply_ssm(p, torch.from_numpy(x), jcfg)
    assert bool(torch.isfinite(y).all()) and state.shape == (1, 50, 16, 64)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(tail.numpy(), np.asarray(rtail), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(rstate), **TOL)


def test_bridge_keeps_hymba_f32_leaves_in_a_bf16_model():
    """The SSM's ``dt_bias`` and ``a_log`` are f32 in the reference's bf16
    Hymba; bridged, they stay f32 beside bf16 weights."""
    jcfg = jax_smoke_config("hymba_1_5b")
    assert jcfg.dtype == "bfloat16"
    params = bridge.params_from_flat(
        _flatten(jtfm.init_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    ssm_params = params["layers"]["ssm"]
    assert ssm_params["dt_bias"].dtype == ssm_params["a_log"].dtype \
        == torch.float32
    assert ssm_params["w_in"].dtype == params["embed"].dtype \
        == torch.bfloat16


def test_bridge_reads_bf16_checkpoint_without_ml_dtypes_dtype(tmp_path):
    """bf16 leaves saved through ml_dtypes load as ``|V2``; the bridge
    reads their bits as bf16."""
    tree = {"embed": jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4),
                                 jnp.bfloat16),
            "layers": {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)}}
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, tree, metadata={"note": "x"})
    params, meta = bridge.load_npz(path, device="cpu")
    assert meta == {"note": "x"}
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  np.asarray(tree["embed"], np.float32))
    np.testing.assert_array_equal(params["layers"]["w"].numpy(),
                                  np.asarray(tree["layers"]["w"]))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16), np.float32) * 3
    p = {"scale": rng.standard_normal(16, np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(16, np.float32)
    ref = jcommon.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind)
    out = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("act", ["silu", "squared_relu", "gelu"])
def test_activations_match(act):
    rng = np.random.default_rng(1)
    h, g = (rng.standard_normal((3, 8), np.float32) for _ in range(2))
    ref = jcommon.activate(jnp.asarray(h), jnp.asarray(g), act)
    out = common.activate(torch.from_numpy(h), torch.from_numpy(g), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-5)


def test_rope_and_per_row_positions_match():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 32), np.float32)
    ref_pos = jcommon.positions_for(None, 2, jnp.asarray([0, 500]), 6)
    pos = common.positions_for(2, torch.tensor([0, 500]), 6)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    ref = jcommon.apply_rope(jnp.asarray(x), ref_pos, 5e5)
    out = common.apply_rope(torch.from_numpy(x), pos, 5e5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("family", [None, "hybrid", "moe", "vlm", "ssm",
                                    "audio"])
def test_only_the_dense_family_is_ported(family):
    """Every family runs: the dense, MoE, VLM, hybrid, ssm and audio
    (encoder-decoder) families' published widths, and what each builds;
    learned positions are accepted for any family (the reference's
    ``_embed``), and only an unknown family or positional code raises."""
    if family is None:
        cfg = get_config("llama3_2_3b")
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
            28, 3072, 24, 8, 128, 8192, 128256)
        tfm.check_supported(cfg)
        return
    if family == "hybrid":
        cfg = get_config("hymba_1_5b")
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.sliding_window, cfg.ssm.state_size) == (
            32, 1600, 25, 5, 64, 1024, 16)
        tfm.check_supported(cfg)
        params = tfm.init_params(get_smoke_config("hymba_1_5b"), device="cpu")
        assert params["layers"]["ssm"]["a_log"].dtype == torch.float32
        with pytest.raises(ValueError, match="paged KV needs"):
            tfm.init_cache(cfg, 1, 64, paged=True, device="cpu")
        return
    if family == "ssm":
        cfg = get_config("rwkv6_7b")
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim,
                cfg.d_ff, cfg.vocab_size, cfg.pos_emb) == (
            32, 4096, 64, 64, 14336, 65536, "none")
        tfm.check_supported(cfg)
        assert not tfm.default_paged(cfg)
        smoke = get_smoke_config("rwkv6_7b")
        params = tfm.init_params(smoke, device="cpu")
        assert set(params["layers"]) == {"ln1", "ln2", "tm", "cm"}
        assert params["layers"]["tm"]["decay_a"].dtype == torch.float32
        with pytest.raises(ValueError, match="paged KV needs"):
            tfm.init_cache(smoke, 1, 64, paged=True, device="cpu")
        learned = smoke.replace(pos_emb="learned")
        tfm.check_supported(learned)
        assert tfm.init_params(learned, device="cpu")["pos_embed"].shape == (
            tfm.LEARNED_POSITIONS, smoke.d_model)
        with pytest.raises(NotImplementedError, match="unknown pos_emb"):
            tfm.check_supported(smoke.replace(pos_emb="alibi"))
        return
    if family == "moe":
        cfg = get_config("olmoe_1b_7b")
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.moe.num_experts,
                cfg.moe.top_k, cfg.moe.expert_d_ff,
                cfg.moe.capacity_factor) == (
            16, 2048, 16, 16, 128, 0, 50304, 64, 8, 1024, 1.25)
        tfm.check_supported(cfg)
        assert tfm.default_paged(cfg)
        params = tfm.init_params(get_smoke_config("olmoe_1b_7b"),
                                 device="cpu")
        assert set(params["layers"]) == {"ln1", "ln2", "attn", "moe"}
        assert params["layers"]["moe"]["router"].dtype == torch.float32
        return
    if family == "vlm":
        cfg = get_config("qwen2_vl_72b")
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.pos_emb) == (
            80, 8192, 64, 8, 128, 29568, 152064, "mrope")
        tfm.check_supported(cfg)
        assert tfm.default_paged(cfg)
        return
    cfg = get_config("whisper_tiny")
    assert (cfg.num_layers, cfg.encoder_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.encoder_seq_len, cfg.pos_emb) == (
        4, 4, 384, 6, 6, 64, 1536, 51865, 1500, "learned")
    tfm.check_supported(cfg)
    assert not tfm.default_paged(cfg)
    smoke = get_smoke_config("whisper_tiny")
    cache = tfm.init_cache(smoke, 2, 16, device="cpu")
    assert cache["cross_k"].shape == (2, 2, 4, 64, 32)   # (L, S, KH, F, dh)
    assert cache["k"].shape == (2, 2, 4, 16, 32)
    with pytest.raises(ValueError, match="paged KV needs"):
        tfm.init_cache(smoke, 1, 16, paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="unknown family"):
        tfm.init_params(smoke.replace(family="speech"), device="cpu")


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_cache(get_smoke_config("llama3_2_3b"), 1, 16)
    assert resolve_device("cpu").type == "cpu"
