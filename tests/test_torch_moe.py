"""The MoE and VLM families of the port against the JAX reference: the
model.

Bridged reference weights, seeded numpy inputs, f32 with JAX at "highest"
matmul precision: ``apply_moe`` (outputs, both auxiliary losses, dropped
slots at the published capacity factor 1.25, top-k ties, each row routed
alone as the reference engine's ``vmap`` does; rows of 1 to 64 tokens,
softmax and sigmoid routers, laid out ``min(C, tg)`` expert rows a group
against capacity-wide rows), ``apply_mrope``;
``forward_seq``, ``forward_chunk`` and ``decode_step`` logits at 1e-4 for
the ``olmoe_1b_7b``, ``moonshot_v1_16b_a3b`` (shared expert),
``kimi_k2_1t_a32b`` and ``qwen2_vl_72b`` smoke configs, every lane of a
batch padded with a replica of lane 0 compared; the VLM example batch's
layout. The engine, training and launcher halves are in
``test_torch_moe_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import common, moe
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tfm

from _torch_moe_common import ARCHS, TOL, _bridged, _t

torch.set_num_threads(1)


# ---------------------------------------------------------------- apply_moe
def _moe_case(e, k, gs, act, seed=0, d=64, f=32):
    jm, m = JaxMoEConfig(e, k, f, 1.25, gs), MoEConfig(e, k, f, 1.25, gs)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, jm, act, jnp.float32)
    return jm, jp, m, {n: _t(v) for n, v in jp.items()}


def _skewed(b, s, d=64, seed=0):
    """Inputs that share a direction, so the router favours a few experts
    and capacity drops slots."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d))
            + 2.0 * rng.standard_normal(d)).astype(np.float32)


@pytest.mark.parametrize("e,k,gs,act", [
    (4, 2, 64, "silu"),            # the smoke configs' experts
    (64, 8, 2048, "silu"),         # olmoe_1b_7b's routing
    (8, 2, 32, "squared_relu"),    # several groups, ungated experts
])
def test_apply_moe_matches_reference_with_drops(e, k, gs, act):
    """Three rows of 32 tokens padded to four with a replica of row 0, at
    capacity factor 1.25: outputs, both losses and the drops match. Where a
    group spans rows, the replica differs from row 0 (capacity couples the
    rows); where groups lie within rows, it equals it."""
    jm, jp, m, p = _moe_case(e, k, gs, act)
    x = _skewed(3, 32)
    x = np.concatenate([x, x[:1]])
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jm, act)
    y, aux = moe.apply_moe(p, _t(x), m, act)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]),
                                   rtol=1e-5)
    assert aux["dropped_slots"].item() > 0
    assert torch.equal(y[3], y[0]) == (gs <= 32)


def test_apply_moe_top_k_ties_take_the_lower_index():
    """Experts 1 and 3 have equal router columns, and a zero router ties
    all four: the port picks the experts ``lax.top_k`` picks."""
    jm, jp, m, p = _moe_case(4, 2, 64, "silu", seed=1)
    x = _skewed(2, 16, seed=1)
    for router in (jp["router"].at[:, 3].set(jp["router"][:, 1]),
                   jnp.zeros_like(jp["router"])):
        jp2 = {**jp, "router": router}
        jy, _ = jmoe.apply_moe(jp2, jnp.asarray(x), jm, "silu")
        y, _ = moe.apply_moe({**p, "router": _t(router)}, _t(x), m, "silu")
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)


def test_apply_moe_per_row_is_the_reference_under_vmap():
    """``per_row`` routes each row as the reference engine's programs do
    (``vmap`` over rows); with drops it differs from one batched call."""
    jm, jp, m, p = _moe_case(4, 2, 64, "silu", seed=2)
    x = _skewed(4, 32, seed=2)
    jy = jax.vmap(lambda r: jmoe.apply_moe(jp, r[None], jm, "silu")[0][0])(
        jnp.asarray(x))
    y, aux = moe.apply_moe(p, _t(x), m, "silu", per_row=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    assert aux["dropped_slots"].item() > 0
    batched, _ = moe.apply_moe(p, _t(x), m, "silu")
    assert not np.allclose(batched.numpy(), y.numpy(), atol=1e-3)


def _cap_wide(x, p, m, act, idx, gates):
    """The reference's layout, written out: per group (G, T, d), a (T, E, C)
    one-hot dispatch of capacity C = the reference's ``_capacity``, slot
    positions counted slot-major, a slot at C or later dropped; in f64.
    ``idx``/``gates`` (G, T, k) are the router's choices. Returns ``(y (G,
    T, d), drops of each token (G, T))``."""
    g, t, _ = x.shape
    e, k = m.num_experts, m.top_k
    cap = jmoe._capacity(t, m)
    x = x.double()
    dispatch = torch.zeros(g, t, e, cap, dtype=torch.float64)
    combine = torch.zeros_like(dispatch)
    drops = torch.zeros(g, t, dtype=torch.int64)
    for gi in range(g):
        counts = [0] * e
        for j in range(k):
            for ti in range(t):
                ex = int(idx[gi, ti, j])
                if counts[ex] < cap:
                    dispatch[gi, ti, ex, counts[ex]] = 1.0
                    combine[gi, ti, ex, counts[ex]] = float(gates[gi, ti, j])
                else:
                    drops[gi, ti] += 1
                counts[ex] += 1
    xe = torch.einsum("gtec,gtd->gecd", dispatch, x)
    up = torch.einsum("gecd,edf->gecf", xe, p["w_up"].double())
    gate = (torch.einsum("gecd,edf->gecf", xe, p["w_gate"].double())
            if "w_gate" in p else None)
    ye = torch.einsum("gecf,efd->gecd", common.activate(up, gate, act),
                      p["w_down"].double())
    return torch.einsum("gtec,gecd->gtd", combine, ye), drops


def _sigmoid_choice(x, p, m, scale):
    """DeepSeek-V3's sigmoid router in f64: the top k of score plus bias
    (ties to the lower index), gates normalised over the k, scaled."""
    scores = torch.sigmoid(x.double() @ p["router"].double())
    order = torch.sort(scores + p["router_bias"].double(), dim=-1,
                       descending=True, stable=True).indices[..., :m.top_k]
    gates = scores.gather(-1, order)
    return order, gates / gates.sum(-1, keepdim=True) * scale


@pytest.mark.parametrize("tg,router,e,k,cf", [
    (1, "softmax", 4, 2, 1.25),     # a decode row: one row per expert
    (3, "softmax", 4, 2, 1.25),     # a short continuation chunk
    (8, "softmax", 4, 2, 1.25),     # min(C, tg) = C = tg
    (64, "softmax", 4, 2, 1.25),    # C = 40 < tg: the width is C, drops
    (1, "sigmoid", 16, 4, 1.25),
    (3, "sigmoid", 16, 4, 1.25),
    (8, "sigmoid", 16, 4, 1.25),
    (64, "sigmoid", 16, 4, 1.25),   # C = 24 < tg
    (8, "softmax", 4, 2, 4.0),      # k * cf > E: C = 16 > tg
])
def test_per_row_expert_rows_fit_the_group(tg, router, e, k, cf,
                                           monkeypatch):
    """Four rows of ``tg`` tokens, each a dispatch of its own, laid out
    ``min(C, tg)`` rows per (expert, group): the outputs are the
    reference's under ``vmap`` (softmax) or a C-wide one-hot dispatch
    (sigmoid), and the drops of each token exactly those of C-wide rows,
    computed from the reference's routing; the expert products run, and
    ``expert_rows`` counts, E x groups x min(C, tg) rows."""
    jm = JaxMoEConfig(e, k, 32, cf, 64)
    m = MoEConfig(e, k, 32, cf, 64)
    x = _skewed(4, tg, seed=tg + e)
    if router == "softmax":
        jp = jmoe.init_moe(jax.random.PRNGKey(tg), 64, jm, "silu",
                           jnp.float32)
        p = {n: _t(v) for n, v in jp.items()}
        routing = None
        jy = jax.vmap(lambda r: jmoe.apply_moe(jp, r[None], jm, "silu")[0][0])(
            jnp.asarray(x))
        logits = jnp.einsum("btd,de->bte", jnp.asarray(x), jp["router"],
                            precision="highest")
        jg, ji = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
        _, want_drops = _cap_wide(_t(x), p, m, "silu", _t(ji).long(), _t(jg))
        want = torch.from_numpy(np.array(jy)).double()
    else:
        gen = torch.Generator().manual_seed(tg)
        p = {n: v[0] for n, v in moe.init_moe(gen, 64, m, "silu",
                                              torch.float32, 1,
                                              router_bias=True).items()}
        p["router_bias"] = torch.randn(e, generator=gen) * 0.1
        routing = moe.SigmoidRouting(2.446)
        idx, gates = _sigmoid_choice(_t(x), p, m, routing.routed_scaling_factor)
        want, want_drops = _cap_wide(_t(x), p, m, "silu", idx, gates)
    rows, bmm = [], torch.bmm
    monkeypatch.setattr(torch, "bmm", lambda a, b: rows.append(
        a.shape[0] * a.shape[1]) or bmm(a, b))
    y, aux = moe.apply_moe(p, _t(x), m, "silu", per_row=True, routing=routing)
    monkeypatch.undo()
    np.testing.assert_allclose(y.double().numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(aux["token_drops"].long(), want_drops)
    assert aux["dropped_slots"].item() == int(want_drops.sum())
    assert (int(want_drops.sum()) > 0) == (tg == 64)
    cap = jmoe._capacity(tg, jm)
    assert moe.groups_of(4, tg, m, per_row=True) == (tg, 4)
    assert moe.expert_rows(tg, 4, m) == e * 4 * min(cap, tg)
    assert rows == [e * 4 * min(cap, tg)] * 3       # up, gate, down


def test_apply_moe_refuses_a_group_that_does_not_divide():
    _jm, _jp, m, p = _moe_case(4, 2, 64, "silu")
    with pytest.raises(ValueError, match="not divisible"):
        moe.apply_moe(p, torch.zeros(3, 32, 64), m, "silu")


# ---------------------------------------------------------------- M-RoPE
def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 32), np.float32)
    thw = rng.integers(0, 300, (3, 2, 5)).astype(np.int32)
    ref = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(thw), 1e6)
    out = common.apply_mrope(_t(x), _t(thw), 1e6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    for dh in (32, 64, 128):
        assert common.mrope_sections(dh) == jcommon.mrope_sections(dh)
    # three equal streams are RoPE
    pos = _t(thw[0]).long()
    torch.testing.assert_close(common.apply_mrope(_t(x), pos.expand(3, 2, 5),
                                                  1e6),
                               common.apply_rope(_t(x), pos, 1e6))


# ---------------------------------------------------------------- models
def _per_row(jparams, jcfg, jcache, toks, step):
    """The reference engine's continuation (``step=False``) or decode
    program on a contiguous reference cache: ``forward_chunk`` or
    ``decode_step`` one row at a time under ``vmap``. Returns ``(logits,
    cache)``."""
    def one(k, v, row):
        c = {"k": k[:, None], "v": v[:, None], "pos": jcache["pos"]}
        fn = (lambda: jtfm.decode_step(jparams, jcfg, c, row[None])) if step \
            else (lambda: jtfm.forward_chunk(jparams, jcfg, row[None], c))
        lg, c = fn()
        return lg[0], c["k"][:, 0], c["v"][:, 0]

    lg, k, v = jax.vmap(one, in_axes=(1, 1, 0), out_axes=(0, 1, 1))(
        jcache["k"], jcache["v"], jnp.asarray(toks))
    return lg, {"k": k, "v": v, "pos": jcache["pos"] + toks.shape[1]}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_match_on_every_lane(arch):
    """Four rows, the last a replica of row 0 (an engine's padding lane):
    a 16-token prefill into a paged cache (the rows routed together, as the
    reference's ``forward_seq`` on the batch), an 8-token chunk and two
    decode steps (each row routed alone, as the reference engine's programs
    under ``vmap``), each stage's logits on every lane, and the summed
    auxiliary losses, match the reference at the published capacity
    factor."""
    jcfg, jparams, cfg, params = _bridged(arch)
    toks = np.random.default_rng(1).integers(0, 2048, (4, 26), np.int32)
    toks[3] = toks[0]
    w = 48
    jl, jcache, jaux = jtfm.forward_seq(jparams, jcfg,
                                        jnp.asarray(toks[:, :16]),
                                        build_cache=True, cache_len=w,
                                        remat="none")
    cache = tfm.init_cache(cfg, 4, w, device="cpu")
    lg, cache, aux = tfm.forward_seq(params, cfg, _t(toks[:, :16]).long(),
                                     cache=cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=1e-5, atol=1e-9)
    if cfg.moe is not None:
        assert aux["dropped_slots"].item() > 0
    jl, jcache = _per_row(jparams, jcfg, jcache, toks[:, 16:24], False)
    lg, cache, _ = tfm.forward_chunk(params, cfg, _t(toks[:, 16:24]).long(),
                                     cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for t in (24, 25):
        jl, jcache = _per_row(jparams, jcfg, jcache, toks[:, t:t + 1], True)
        lg, cache, _ = tfm.decode_step(params, cfg, cache,
                                       _t(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


def test_vlm_example_batch_has_the_reference_layout():
    cfg = get_smoke_config("qwen2_vl_72b")
    b = tmodel.example_batch(cfg, 2, 16, device="cpu")
    p = cfg.vision_prefix_len
    jb = jmodel.example_batch(jax_smoke_config("qwen2_vl_72b"), 2, 16,
                              jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in b.items()} == \
        {k: v.shape for k, v in jb.items()}
    assert b["vision_embeds"].dtype == torch.bfloat16
    assert b["loss_mask"][:, :p].sum() == 0 and b["loss_mask"][:, p:].all()
    np.testing.assert_array_equal(b["mrope_positions"].numpy(),
                                  np.asarray(jb["mrope_positions"]))

