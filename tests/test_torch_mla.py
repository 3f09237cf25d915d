"""Moonlight-16B-A3B's block in the port, on the CPU at smoke widths in f32
against the benchmark's plain reference (``bench/reference/mla.py``), on
seeded random weights drawn by the benchmark (``bench/archs/mla.py``):
multi-head latent attention (non-absorbed prefill, absorbed decode through
the latent paged pool), the dense first layer, the sigmoid router with its
selection bias and the shared experts.

Tolerances: both sides compute in f32 on the CPU, in other orders of
products (the program absorbs W_UK into the query and unfolds W_UV after
attention, blocks its softmax, and routes each decode row alone), so
logits agree to f32 rounding over a few layers: 1e-4 absolute against
logits of magnitude ~1 (the reference's own f32 error over three layers is
~1e-6; a wrong scale or a dropped term moves logits by 1e-2 or more).
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
from bench.reference import mla as ref  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.configs.latent import LatentConfig, is_latent  # noqa: E402
from repro_torch.kernels.flash_decode.ops import (  # noqa: E402
    latent_decode_attention, latent_decode_attention_plain)
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

CPU = torch.device("cpu")
ARCH = spec.arch("mla")
TOL = dict(atol=1e-4, rtol=1e-4)


def _model(capacity_factor=8.0) -> dict:
    """The smoke widths as the benchmark's model dict, f32; capacity 8x
    (no drops) unless told otherwise."""
    return tiny.config("moonlight_16b_a3b", dtype="float32",
                       capacity_factor=capacity_factor)["model"]


def _setup(seed=3, **kw):
    m = _model(**kw)
    cfg = ARCH.program_config({"model": m})
    return m, cfg, ARCH.make_params(cfg, seed, CPU)


def test_config_is_found_by_module_and_keeps_the_registry():
    cfg = get_config("moonlight_16b_a3b")
    assert isinstance(cfg, LatentConfig) and is_latent(cfg)
    assert "moonlight_16b_a3b" not in ARCH_IDS
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_lora_rank,
            cfg.qk_head_dim, cfg.v_head_dim, cfg.latent_dim) == \
        (27, 2048, 16, 512, 192, 128, 576)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_d_ff,
            cfg.d_ff, cfg.first_k_dense, cfg.dense_d_ff) == \
        (64, 6, 1408, 2816, 1, 11264)
    assert (cfg.scoring, cfg.routed_scaling_factor, cfg.rope_theta,
            cfg.vocab_size) == ("sigmoid", 2.446, 50_000.0, 163840)
    assert not is_latent(get_config("moonshot_v1_16b_a3b"))
    assert is_latent(get_smoke_config("moonlight_16b_a3b"))


def test_param_count_at_published_widths_on_meta():
    """15.96 B parameters, counted from the widths and from the leaves
    ``init_params`` makes on ``meta`` (nothing allocated)."""
    cfg = get_config("moonlight_16b_a3b")
    params = tfm.init_params(cfg, device="meta")
    leaves = sum(t.numel() for t in _leaves(params))
    assert leaves == tfm.param_count(cfg)
    assert round(leaves / 1e9, 2) == 15.96


def _leaves(t):
    for v in t.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_layer_zero_is_dense():
    """Layer 0 holds the dense MLP of ``dense_d_ff`` and no MoE leaves;
    every later layer the experts, their bias and the shared experts."""
    cfg = get_smoke_config("moonlight_16b_a3b")
    params = tfm.init_params(cfg, 0, device="cpu")
    trees = tfm.layer_trees(params)
    assert len(trees) == cfg.num_layers
    assert "moe" not in trees[0] and "moe" not in params["dense_layers"]
    assert trees[0]["mlp"]["w_up"].shape == (cfg.d_model, cfg.dense_d_ff)
    for lp in trees[1:]:
        assert set(lp["moe"]) >= {"router", "router_bias", "w_up"}
        assert lp["mlp"]["w_up"].shape == (cfg.d_model, cfg.d_ff)
    assert set(trees[1]["attn"]) == {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}


def test_forward_seq_logits_equal_the_reference():
    """Two rows dispatched together, every position's logits."""
    m, cfg, params = _setup()
    tokens = torch.randint(0, m["vocab_size"], (2, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _, _ = tfm.forward_seq(params, cfg, tokens)
    for row in range(2):
        want = ref.logits(params, m, tokens, row, tokens[0, :0], [],
                          list(range(12)))
        torch.testing.assert_close(got[row], want, **TOL)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_chunked_prefill_then_absorbed_decode_equal_the_reference(
        capacity_factor):
    """A first chunk of two rows dispatched together (into a latent paged
    pool), a continuation chunk per row, then absorbed decode steps: every
    position's logits equal the reference's full forward with the same
    dispatches (at capacity 1.25 too, where experts drop slots)."""
    m, cfg, params = _setup(capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(2)
    first = torch.randint(0, m["vocab_size"], (2, 8), generator=gen)
    chunk = torch.randint(0, m["vocab_size"], (2, 8), generator=gen)
    steps = torch.randint(0, m["vocab_size"], (2, 4), generator=gen)
    with torch.no_grad():
        l0, cache, _ = tfm.forward_seq(params, cfg, first, build_cache=True,
                                       cache_len=32)
        assert set(cache) == {"latent", "tables", "pos"}
        assert cache["latent"].shape[-1] == cfg.latent_dim
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


def test_latent_decode_plain_equals_plain_attention():
    """Absorbed decode over a paged latent pool (shuffled blocks, ragged
    lengths) against non-absorbed attention: keys ``[c W_UK | k_pe]`` and
    values ``c W_UV`` per head, scale ``1/sqrt(nope + rope)``. Both in
    f32: equal to rounding (1e-5)."""
    cfg = get_smoke_config("moonlight_16b_a3b").replace(dtype="float32")
    gen = torch.Generator().manual_seed(4)
    h, r, dr, dn, dv = (cfg.num_heads, cfg.kv_lora_rank,
                        cfg.qk_rope_head_dim, cfg.qk_nope_head_dim,
                        cfg.v_head_dim)
    p = {"wkv_b": torch.randn(r, h * (dn + dv), generator=gen) / r ** 0.5}
    b, bs, mb = 3, 4, 5
    pool = torch.randn(b * mb + 1, bs, r + dr, generator=gen)
    tables = torch.randperm(b * mb, generator=gen).view(b, mb).int()
    lengths = torch.tensor([1, 13, 20], dtype=torch.int32)
    q = torch.randn(b, h, dn + dr, generator=gen)
    out = mla.unabsorb(p, latent_decode_attention(
        mla.absorb(p, q, cfg), pool, tables, lengths, r, mla.scale(cfg)), cfg)
    lane = pool[tables.long()].reshape(b, mb * bs, r + dr)
    w = mla._heads_of(p, cfg)
    k = torch.cat([torch.einsum("bwr,rhd->bwhd", lane[..., :r], w[..., :dn]),
                   lane[:, :, None, r:].expand(-1, -1, h, -1)], -1)
    v = torch.einsum("bwr,rhd->bwhd", lane[..., :r], w[..., dn:])
    s = torch.einsum("bhd,bwhd->bhw", q, k) / math.sqrt(dn + dr)
    s = s.masked_fill(torch.arange(mb * bs)[None, None] >= lengths[:, None,
                                                                   None],
                      float("-inf"))
    want = torch.einsum("bhw,bwhd->bhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    # the CPU wrapper is the plain version
    assert torch.equal(
        latent_decode_attention(q.new_ones(b, h, r + dr), pool, tables,
                                lengths, r, 0.1),
        latent_decode_attention_plain(q.new_ones(b, h, r + dr), pool,
                                      tables, lengths, r, 0.1))


def _route(bias, k=3, scale=2.446):
    logits = torch.randn(1, 5, 8, generator=torch.Generator().manual_seed(6))
    return logits, moe._sigmoid_gates(logits, bias, k,
                                      moe.SigmoidRouting(scale))


def test_router_bias_chooses_and_does_not_weigh():
    """The bias moves which experts are chosen, not their gates: each gate
    is the chosen expert's sigmoid score over the chosen scores' sum, times
    2.446; the gates sum to 2.446; a zero bias is plain sigmoid top-k."""
    zero = torch.zeros(8)
    logits, (scores, gates, idx) = _route(zero)
    torch.testing.assert_close(scores, torch.sigmoid(logits))
    top = torch.topk(torch.sigmoid(logits), 3, -1).indices
    assert torch.equal(idx, top)
    torch.testing.assert_close(gates.sum(-1), torch.full((1, 5), 2.446))
    bias = torch.zeros(8)
    bias[7] = 10.0                            # expert 7 always chosen
    _, (_, gates_b, idx_b) = _route(bias)
    assert (idx_b == 7).any(-1).all() and not torch.equal(idx_b, idx)
    chosen = scores.gather(-1, idx_b)
    torch.testing.assert_close(gates_b, 2.446 * chosen
                               / chosen.sum(-1, keepdim=True))
    torch.testing.assert_close(gates_b.sum(-1), torch.full((1, 5), 2.446))


def test_softmax_router_is_unchanged_without_routing():
    """OLMoE's softmax router is what ``apply_moe`` runs without a
    ``routing``, and a config without ``scoring`` gets none."""
    cfg = get_smoke_config("olmoe_1b_7b").replace(dtype="float32")
    assert moe.routing_of(cfg) is None
    assert moe.routing_of(get_smoke_config("moonlight_16b_a3b")) == \
        moe.SigmoidRouting(2.446)
    p = tfm.init_params(cfg, 0, device="cpu")["layers"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    a, _ = moe.apply_moe(p, x, cfg.moe, cfg.activation)
    b, _ = moe.apply_moe(p, x, cfg.moe, cfg.activation, routing=None)
    assert torch.equal(a, b)
    assert "router_bias" not in p


def test_latent_cache_is_paged_only():
    cfg = get_smoke_config("moonlight_16b_a3b")
    with pytest.raises(ValueError, match="paged only"):
        tfm.init_cache(cfg, 2, 32, paged=False, device="cpu")
    with pytest.raises(NotImplementedError, match="kernel route"):
        tfm.forward_seq(tfm.init_params(cfg, 0, device="cpu"), cfg,
                        torch.zeros(1, 8, dtype=torch.long),
                        attn_impl="naive")


def test_shared_experts_run_in_every_moe_layer():
    """Without the shared experts the logits move: they reach the
    output."""
    m, cfg, params = _setup()
    tokens = torch.randint(0, m["vocab_size"], (1, 10),
                           generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        full, _, _ = tfm.forward_seq(params, cfg, tokens)
        bare = {**params, "layers": {k: v for k, v in
                                     params["layers"].items() if k != "mlp"}}
        cut, _, _ = tfm.forward_seq(bare, cfg, tokens)
    assert (full - cut).abs().max() > 1e-2


def test_moe_drops_are_counted_behind_the_dense_layer():
    """The dense layer 0's aux holds no MoE keys; the summed aux still
    carries the MoE layers' drops and losses."""
    m, cfg, params = _setup(capacity_factor=1.25)
    tokens = torch.randint(0, m["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        _, _, aux = tfm.forward_seq(params, cfg, tokens)
    assert {"token_drops", "dropped_slots", "load_balance_loss",
            "router_z_loss"} <= set(aux)
    assert aux["token_drops"].shape == (2, 32)
    assert int(aux["dropped_slots"]) == int(aux["token_drops"].sum())
