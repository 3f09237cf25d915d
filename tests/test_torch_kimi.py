"""Kimi-K2-Instruct's block in the port (one chip's share of an
expert-parallel layer), on the CPU at smoke widths in f32 against the
benchmark's plain reference (``bench/reference/mla_ep.py``), on seeded
random weights drawn by the benchmark (``bench/archs/mla_ep.py``): the
query low-rank path, YaRN, the RMSNorm epsilon, 4 heads of MLA over the
latent paged pool, and 16 routed experts of which the chip holds 2 (one
of 8 shares).

Tolerances as ``tests/test_torch_mla.py``'s: both sides in f32 in other
orders of products, 1e-4 on logits of magnitude ~1; the shares' sum
against the uncut layer to 1e-5 (one layer).
"""
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for path in (str(ROOT), str(ROOT / "bench" / "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)

import _bench_tiny as tiny  # noqa: E402
from bench.harness import spec  # noqa: E402
from bench.reference import lm as ref_lm  # noqa: E402
from bench.reference import mla_ep as ref  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.configs.latent import (LatentConfig, is_latent,  # noqa: E402
                                        yarn)
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import apply_norm  # noqa: E402

CPU = torch.device("cpu")
ARCH = spec.arch("mla_ep")
TOL = dict(atol=1e-4, rtol=1e-4)
SCALE = 0.130861          # 192^-0.5 x (0.1 ln 32 + 1)^2, to six places


def _setup(seed=3, capacity_factor=8.0):
    m = tiny.config("kimi_k2_instruct_ep8", dtype="float32",
                    capacity_factor=capacity_factor)["model"]
    cfg = ARCH.program_config({"model": m})
    return m, cfg, ARCH.make_params(cfg, seed, CPU)


def test_config_is_the_share_at_published_widths():
    """Found by module, kept out of the registry; every width as published,
    the router over 384 with top 8, 48 held; 23.41 B parameters counted
    from the widths and from the leaves made on ``meta``."""
    cfg = get_config("kimi_k2_instruct")
    assert isinstance(cfg, LatentConfig) and is_latent(cfg)
    assert "kimi_k2_instruct" not in ARCH_IDS
    assert (cfg.d_model, cfg.num_heads, cfg.q_lora_rank, cfg.kv_lora_rank,
            cfg.qk_head_dim, cfg.v_head_dim, cfg.dense_d_ff, cfg.d_ff) == \
        (7168, 64, 1536, 512, 192, 128, 18432, 2048)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_d_ff,
            cfg.experts_held, cfg.num_layers, cfg.vocab_size) == \
        (384, 8, 2048, 48, 11, 20480)
    assert (cfg.norm_eps, cfg.routed_scaling_factor) == (1e-6, 2.827)
    params = tfm.init_params(cfg, device="meta")
    leaves = sum(t.numel() for t in _leaves(params))
    assert leaves == tfm.param_count(cfg)
    assert round(leaves / 1e9, 2) == 23.41
    lay = params["layers"]
    assert lay["moe"]["router"].shape == (10, 7168, 384)
    assert lay["moe"]["router_bias"].shape == (10, 384)
    assert lay["moe"]["w_up"].shape == (10, 48, 7168, 2048)
    assert set(lay["attn"]) == {"wq_a", "q_norm", "wq_b", "wkv_a",
                                "kv_norm", "wkv_b", "wo"}


def _leaves(t):
    for v in t.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_yarn_frequencies_and_scale_are_the_hand_values():
    """Pairs 0-19 keep theta^(-2i/64), 20-31 are slowed 32x (corr(1) =
    19.17: low 19, high 20); cos and sin unscaled; the softmax scale
    0.130861; the reference computes the same frequencies."""
    cfg = get_config("kimi_k2_instruct")
    y = yarn(cfg)
    corr = 64 * math.log(4096 / (2 * math.pi)) / (2 * math.log(50000))
    assert (y.low, y.high) == (math.floor(corr), math.ceil(corr)) == (19, 20)
    assert y.rope_scale == 1.0
    assert mla.scale(cfg) == pytest.approx(SCALE, abs=5e-7)
    freqs = mla._yarn_freqs(cfg, y, CPU)
    plain = 50000.0 ** -(torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    torch.testing.assert_close(freqs[:20].double(), plain[:20], rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(freqs[20:].double(), plain[20:] / 32,
                               rtol=1e-6, atol=0)
    m = tiny.config("kimi_k2_instruct_ep8")["model"]
    m.update({k: getattr(cfg, k) for k in ("qk_nope_head_dim",
                                           "qk_rope_head_dim")})
    torch.testing.assert_close(ref.yarn_freqs(m, CPU), freqs, rtol=1e-6,
                               atol=0)
    assert ref.softmax_scale(m) == pytest.approx(mla.scale(cfg), rel=1e-12)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_prefill_then_latent_decode_equal_the_reference(capacity_factor):
    """A first chunk of two rows dispatched together into the latent
    pool, a continuation chunk per row, then absorbed decode steps: every
    position's logits equal the reference's full forward with the same
    dispatches (at capacity 1.25 too, where experts drop slots); each
    position's held slots lie between 0 and k a layer."""
    m, cfg, params = _setup(capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(2)
    first = torch.randint(0, m["vocab_size"], (2, 8), generator=gen)
    chunk = torch.randint(0, m["vocab_size"], (2, 8), generator=gen)
    steps = torch.randint(0, m["vocab_size"], (2, 4), generator=gen)
    with torch.no_grad():
        l0, cache, aux = tfm.forward_seq(params, cfg, first,
                                         build_cache=True, cache_len=32)
        assert aux["token_held"].shape == (2, 8)
        assert int(aux["token_held"].max()) <= 2 * cfg.moe.top_k
        l1, cache, _ = tfm.forward_chunk(params, cfg, chunk, cache)
        ls = []
        for i in range(4):
            out, cache, _ = tfm.decode_step(params, cfg, cache,
                                            steps[:, i:i + 1])
            ls.append(out)
    got = torch.cat([l0, l1, torch.stack(ls, 1)], 1)
    for row in range(2):
        own = torch.cat([chunk[row], steps[row]])
        segs = [(0, 8, "chunk")] + [(8 + i, 9 + i, "token") for i in range(4)]
        want = ref.logits(params, m, first, row, own, segs, list(range(20)))
        torch.testing.assert_close(got[row], want, **TOL)


def test_the_shares_add_up_to_the_uncut_layer():
    """Every chip's share of one MoE layer (8 shares of 2 experts: the
    program's ``apply_moe`` for the first, its dispatch told ``first`` and
    ``experts`` for each), with the shared expert counted once, sums to
    the uncut reference's whole layer (every expert held); each share's
    ``token_held`` sums to k a token; the first share equals the
    reference's cut to that share."""
    m, cfg, params = _setup(capacity_factor=1.25)
    full = {**params["layers"]["moe"]}
    gen = torch.Generator().manual_seed(5)
    for k in ("w_up", "w_gate", "w_down"):      # all 16 experts' weights
        full[k] = torch.randn(2, 16, *full[k].shape[2:], generator=gen) \
            / math.sqrt(full[k].shape[2])
    p = {k: v[0] for k, v in full.items()}
    mp = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    x = torch.randn(1, 32, m["d_model"], generator=gen)
    routing = moe.routing_of(cfg)
    h = cfg.experts_held
    parts, held = [], 0
    for s in range(cfg.moe.num_experts // h):
        mine = slice(s * h, (s + 1) * h)
        y, _f, _p, _z, _d, here = moe._dispatch(
            x.view(1, 32, -1), p["router"], p["w_up"][mine],
            p["w_gate"][mine], p["w_down"][mine], moe=cfg.moe,
            activation=cfg.activation, first=s * h, experts=h,
            routing=routing, bias=p["router_bias"], count_held=True)
        parts.append(y[0])
        held = held + here
    assert torch.equal(held, torch.full_like(held, cfg.moe.top_k))
    first = {**p, **{k: p[k][:h] for k in ("w_up", "w_gate", "w_down")}}
    y0, aux = moe.apply_moe(first, x, cfg.moe, cfg.activation,
                            routing=routing, held=h)
    assert torch.equal(y0[0], parts[0])
    shared = ref_lm._swiglu(x[0], mp["w_up"], mp["w_gate"], mp["w_down"],
                            "f32")
    uncut = dict(m, experts_held=0)
    want = shared + ref.moe_dispatch(x[0], full, 0, uncut, 32, "f32")
    torch.testing.assert_close(sum(parts) + shared, want, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(
        y0[0], ref.moe_dispatch(x[0], full, 0, m, 32, "f32"), atol=1e-5,
        rtol=1e-5)


def _rope_before(x, positions, theta):
    """``models/common.py``'s ``apply_rope`` before YaRN, verbatim."""
    from repro_torch.models.common import rope_freqs
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def _project_before(p, xn, cfg, positions):
    """``mla.project`` before the query path, YaRN and the epsilon,
    verbatim."""
    b, s, _ = xn.shape
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (xn @ p["wq"]).view(b, s, cfg.num_heads, cfg.qk_head_dim)
    q = torch.cat([q[..., :dn], _rope_before(q[..., dn:], positions,
                                             cfg.rope_theta)], -1)
    kv = xn @ p["wkv_a"]
    c = apply_norm(p["kv_norm"], kv[..., :r], "rmsnorm")
    k_pe = _rope_before(kv[..., None, r:], positions, cfg.rope_theta)
    return q, torch.cat([c, k_pe[:, :, 0]], -1)


def _moonlight_logits(cfg):
    params = tfm.init_params(cfg, 4, device="cpu")
    gen = torch.Generator().manual_seed(6)
    first = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    step = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
    with torch.no_grad():
        l0, cache, _ = tfm.forward_seq(params, cfg, first, build_cache=True,
                                       cache_len=32)
        l1, cache, _ = tfm.forward_chunk(params, cfg, first, cache)
        l2, _, aux = tfm.decode_step(params, cfg, cache, step)
    assert "token_held" not in aux
    return torch.cat([l0, l1, l2[:, None]], 1)


def test_moonlight_is_bit_identical_with_the_new_fields_at_defaults(
        monkeypatch):
    """Moonlight's smoke model (no query path, plain rope, eps 1e-5, every
    expert held; f32 with capacity drops) gives the same logits bit for
    bit as with the attention's projection and prefill scale as they were
    before these fields, and as with ``experts_held`` equal to E."""
    cfg = get_smoke_config("moonlight_16b_a3b").replace(dtype="float32")
    now = _moonlight_logits(cfg)
    assert torch.equal(now, _moonlight_logits(cfg.replace(
        experts_held=cfg.moe.num_experts)))
    prefill = mla.prefill_attention
    monkeypatch.setattr(mla, "project", _project_before)
    monkeypatch.setattr(mla, "prefill_attention",
                        lambda *a, scale=None, **kw: prefill(*a, **kw))
    assert torch.equal(now, _moonlight_logits(cfg))


def test_served_query_span_and_held_slots():
    """The smoke share served with chunked prefill: ``mla.q_lora`` opens
    inside each layer's ``model.attn``, once a layer a forward;
    ``held_slots`` counts the real positions' slots routed to the 2 held
    experts, between 0 and ``routed_slots`` (about 2/16 of them)."""
    from repro_torch import trace
    from repro_torch.core.scheduler.policies import fcfs
    from repro_torch.core.scheduler.request import Request
    from repro_torch.core.scheduler.scheduler import Scheduler
    from repro_torch.serving.config import ServingConfig
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import BlockAllocator

    _m, cfg, params = _setup(capacity_factor=1.25)
    eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=4),
                 cache_len=64, prompt_len=32,
                 allocator=BlockAllocator(64, 16), record_tokens=True,
                 config=ServingConfig(prefill_chunk_tokens=16), device="cpu")
    eng.submit([Request(i, " ".join(f"q{i}w{j}" for j in range(3 + 5 * i)),
                        0.0, 32, 5 + i) for i in range(6)])
    trace.enable()
    try:
        fin = eng.run()
    finally:
        trace.disable()
    assert len(fin) == 6
    rec = trace.records()
    spans = [s for s in rec if s.name == "mla.q_lora"]
    forwards = [s for s in rec if s.name in (
        "model.forward_seq", "model.forward_chunk", "model.decode_step")]
    assert len(spans) == len(forwards) * cfg.num_layers
    assert all(rec[s.parent].name == "model.attn" for s in spans)
    be = eng.backend
    assert 0 < be.held_slots < be.routed_slots
    assert abs(be.held_slots / be.routed_slots - 2 / 16) < 0.1
