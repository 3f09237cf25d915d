"""The MoE and VLM families of the port against the JAX reference: the
engine's programs, training and the launchers.

Bridged reference weights, seeded numpy inputs, f32 with JAX at "highest"
matmul precision: the engine's continuation and decode programs route each
row alone; ``lm_loss`` and its per-leaf gradients (vision prefix and M-RoPE
positions included); the paged engine's greedy tokens per ``req_id``
against the JAX ``Engine`` (FCFS and PARS, chunked prefill, prefix
caching) at capacity factor 4.0; the reference's padding-lane overwrite
(ROADMAP C3), which the port's engine does not copy; and the launchers (the
MoE smoke config trains with its auxiliary losses; ``--full`` refuses what
fits no device). The model half is in ``test_torch_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scheduler.policies import fcfs as jax_fcfs
from repro.core.scheduler.policies import make_policy as jax_make_policy
from repro.core.scheduler.request import Request as JaxRequest
from repro.core.scheduler.scheduler import Scheduler as JaxScheduler
from repro.models import model as jmodel
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JaxEngine
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.scheduler.policies import fcfs, make_policy
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine

from _torch_moe_common import TOL, _bridged, _t

torch.set_num_threads(1)

def test_engine_programs_route_each_row_alone():
    """The reference engine continues and decodes one row at a time (under
    ``vmap``); ``forward_chunk`` and ``decode_step`` give the same logits
    for a batch of rows at different offsets, each row its own MoE
    dispatch."""
    jcfg, jparams, cfg, params = _bridged("olmoe_1b_7b")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 2048, (2, 49), np.int32)
    starts = [16, 8]
    w = 64
    cache = tfm.init_cache(cfg, 2, w, device="cpu")
    refs = []
    for b, s0 in enumerate(starts):
        row = jnp.asarray(toks[b:b + 1])
        _, jc, _ = jtfm.forward_seq(jparams, jcfg, row[:, :s0],
                                    build_cache=True, cache_len=w,
                                    remat="none")
        jl, jc = jtfm.forward_chunk(jparams, jcfg, row[:, s0:s0 + 32], jc)
        jd, _ = jtfm.decode_step(jparams, jcfg, jc,
                                 row[:, s0 + 32:s0 + 33])
        refs.append((np.asarray(jl[0]), np.asarray(jd[0])))
        one = {**cache, "tables": cache["tables"][b:b + 1],
               "pos": cache["pos"][b:b + 1]}
        tfm.forward_seq(params, cfg, _t(toks[b:b + 1, :s0]).long(),
                        cache=one)
    chunk = np.stack([toks[b, s0:s0 + 32] for b, s0 in enumerate(starts)])
    step = np.stack([toks[b, s0 + 32:s0 + 33] for b, s0 in enumerate(starts)])
    pos = torch.tensor(starts, dtype=torch.int32)
    lg, cache = tfm.forward_chunk(params, cfg, _t(chunk).long(),
                                  {**cache, "pos": pos})
    ld, _ = tfm.decode_step(params, cfg, cache, _t(step).long())
    for b, (rl, rd) in enumerate(refs):
        np.testing.assert_allclose(lg[b].numpy(), rl, **TOL)
        np.testing.assert_allclose(ld[b].numpy(), rd, **TOL)


# ---------------------------------------------------------------- training
def _vlm_batch(cfg, b=2, s=20, seed=5):
    """A batch with a vision prefix and distinct (t, h, w) streams."""
    rng = np.random.default_rng(seed)
    p = cfg.vision_prefix_len
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - p)),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)),
           "vision_embeds": rng.standard_normal(
               (b, p, cfg.d_model)).astype(np.float32) * 0.02,
           "mrope_positions": np.stack([
               np.broadcast_to(np.arange(s), (b, s)),
               np.broadcast_to(np.arange(s) // 3, (b, s)),
               np.broadcast_to(np.arange(s) % 5, (b, s))]),
           "loss_mask": np.concatenate([np.zeros((b, p)),
                                        np.ones((b, s - p))], 1)}
    out = {k: v.astype(np.float32 if k in ("vision_embeds", "loss_mask")
                       else np.int32) for k, v in out.items()}
    jb = {k: jnp.asarray(v) for k, v in out.items()}
    tb = {k: _t(v).long() if v.dtype == np.int32 else _t(v)
          for k, v in out.items()}
    return jb, tb


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen2_vl_72b"])
def test_lm_loss_and_grads_match(arch):
    """The loss (CE plus the auxiliary losses) to 1e-5 relative and every
    leaf's gradient to 1e-4 of its max |g|, against ``jax.grad``."""
    jcfg, jparams, cfg, params = _bridged(arch)
    jb, tb = _vlm_batch(cfg)
    if cfg.family != "vlm":
        for d in (jb, tb):
            for k in ("vision_embeds", "mrope_positions"):
                d.pop(k)
            d["tokens"] = d["targets"]
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jmodel.lm_loss(p, jcfg, jb, remat="none"),
        has_aux=True)(jparams)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in bridge.flatten(params).items()}
    loss, met = tmodel.lm_loss(bridge.unflatten(leaves), cfg, tb,
                               remat="full")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in jmet.items():
        got = float(torch.as_tensor(met[k]).detach())
        np.testing.assert_allclose(got, float(v), rtol=1e-5, atol=1e-9,
                                   err_msg=k)
        if cfg.moe is not None and k != "ce":
            assert got > 0, k
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    jg = _flatten(jg)
    assert set(grads) == set(jg)
    for k, ref in jg.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)


# ---------------------------------------------------------------- engine
def _words(n, tag):
    return " ".join(f"{tag}w{j}" for j in range(n))


def _workload(req_cls):
    """Three prompts of one bucket sharing a prefix beside a short one, so
    that under FCFS an MoE first-chunk dispatch holds three requests
    (padded to four), then two more with the shared prefix for the freed
    slots (prefix-cache hits)."""
    shared = _words(24, "sys")
    reqs = [req_cls(i, shared + " " + _words(6, f"u{i}"), 0.0, 32, 4 + i)
            for i in range(3)]
    reqs.append(req_cls(3, _words(5, "short"), 0.0, 32, 6))
    return reqs + [req_cls(10 + i, shared + " " + _words(4, f"late{i}"),
                           0.0, 32, 5) for i in range(2)]


def _scorer(prompts):
    """A fixed ranking for both engines: longer prompts first."""
    return np.asarray([-len(p) for p in prompts], np.float32)


def _serve(port, setup, policy, chunk, caching, reqs=None):
    jcfg, jparams, cfg, params = setup
    if port:
        pol = fcfs() if policy == "fcfs" else make_policy("pars", _scorer)
        eng = Engine(cfg, params, Scheduler(policy=pol, max_batch=4),
                     cache_len=96, prompt_len=32, prefill_chunk_tokens=chunk,
                     prefix_caching=caching, record_tokens=True,
                     device="cpu")
    else:
        pol = jax_make_policy(policy, _scorer if policy == "pars" else None)
        eng = JaxEngine(jcfg, jparams, JaxScheduler(policy=pol, max_batch=4),
                        cache_len=96, prompt_len=32,
                        prefill_chunk_tokens=chunk, prefix_caching=caching,
                        record_tokens=True)
    eng.submit(reqs if reqs is not None
               else _workload(Request if port else JaxRequest))
    fin = eng.run()
    return {r.req_id: r.generated_tokens for r in fin}, eng


COUNTERS = ("prefill_dispatches", "extend_dispatches", "prefill_requests",
            "prefix_installs", "prefix_tokens_copied")


@pytest.mark.parametrize("arch,policy,chunk,caching", [
    ("olmoe_1b_7b", "fcfs", None, False),
    ("olmoe_1b_7b", "pars", 16, True),
    ("moonshot_v1_16b_a3b", "fcfs", 16, True),
    ("qwen2_vl_72b", "pars", 16, True),
    ("qwen2_vl_72b", "fcfs", None, False),
])
def test_engine_tokens_match_jax_engine(arch, policy, chunk, caching):
    """Paged, greedy, capacity factor 4.0 (no slot is dropped, so the
    reference's padding lanes do not change its tokens: C3): the same
    tokens per request and the same dispatch counters. MoE first chunks
    are padded as the reference pads them; nothing else is."""
    setup = _bridged(arch, 4.0)
    ref, jeng = _serve(False, setup, policy, chunk, caching)
    out, eng = _serve(True, setup, policy, chunk, caching)
    assert eng.backend.paged and jeng.backend.paged
    assert out == ref and len(out) == 6
    for counter in COUNTERS:
        assert getattr(eng.backend, counter) == getattr(jeng.backend,
                                                        counter), counter
    if caching:
        assert eng.backend.prefix_installs > 0
    if get_smoke_config(arch).family != "moe":
        assert eng.backend.prefill_pad_lanes == 0
    elif (policy, chunk) == ("fcfs", None):
        assert eng.backend.prefill_pad_lanes > 0
    assert eng.allocator.used_blocks == 0


def _resident_k(pool, table, layer_first):
    """A request's K rows from a pool through its table: (L, rows, KH, dh).
    The port's pools are (L, N+1, bs, ...), the reference's (N+1, L, bs,
    ...)."""
    x = pool[:, table] if layer_first else np.moveaxis(pool[table], 1, 0)
    return x.reshape(x.shape[0], -1, *x.shape[3:])


def test_padding_lane_overwrite_c3():
    """ROADMAP C3. At the published capacity factor, one first-chunk
    dispatch of three requests padded to four: the reference's ``_place``
    leaves request 0 with its replica's K, which differs from lane 0's own;
    the port's engine keeps lane 0's own, and then its own first token."""
    setup = _bridged("olmoe_1b_7b")
    jcfg, jparams, cfg, params = setup
    resident = {}
    for port in (False, True):
        reqs = _workload(Request if port else JaxRequest)[:4]
        if port:
            eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=4),
                         cache_len=96, prompt_len=32, record_tokens=True,
                         device="cpu")
        else:
            eng = JaxEngine(jcfg, jparams,
                            JaxScheduler(policy=jax_fcfs(), max_batch=4),
                            cache_len=96, prompt_len=32, record_tokens=True)
        eng.submit(reqs)
        eng.core.tick()                     # admission, prefill, one decode
        table = eng.core.allocator.block_table(0)[:2]     # positions 0..31
        pool = (eng.backend.k_pool.numpy() if port
                else np.asarray(eng.backend.k_pool))
        resident[port] = _resident_k(pool, table, port)
        ids = [eng.backend._prompt_ids(r)[:32] for r in reqs[:3]]
        first = reqs[0].generated_tokens[0]
        resident[port, "first"] = first
    # the dispatch as both engines run it: three prompts and a replica
    tokens = np.zeros((4, 32), np.int32)
    for j, row in enumerate(ids + ids[:1]):
        tokens[j, :len(row)] = row
    jl, jcache, _ = jtfm.forward_seq(jparams, jcfg, jnp.asarray(tokens),
                                     build_cache=True, cache_len=32,
                                     remat="none")
    lane0 = np.asarray(jcache["k"][:, 0])
    replica = np.asarray(jcache["k"][:, 3])
    assert np.abs(lane0 - replica).max() > 1e-2
    np.testing.assert_array_equal(resident[False], replica)
    np.testing.assert_allclose(resident[True], lane0, **TOL)
    assert resident[True, "first"] == int(np.argmax(jl[0, -1]))
    assert resident[False, "first"] == int(np.argmax(jl[3, -1]))
    assert int(np.argmax(jl[0, -1])) != int(np.argmax(jl[3, -1]))


# ---------------------------------------------------------------- launchers
def test_train_launcher_carries_the_auxiliary_losses(capsys):
    """The MoE smoke config trains; each step's metrics carry the
    load-balance and router z-losses, as the reference's step does."""
    _, history = launch_train.main(["--arch", "olmoe-1b-7b", "--device",
                                    "cpu", "--steps", "2", "--batch", "2",
                                    "--seq", "16"])
    assert len(history) == 2
    for h in history:
        assert np.isfinite(h["loss"]) and h["load_balance_loss"] > 0
        assert h["router_z_loss"] > 0
    assert "training olmoe-1b-7b" in capsys.readouterr().out


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_full_launchers_refuse_what_does_not_fit(launcher):
    """kimi_k2_1t_a32b's 1.04 T parameters fit no device: ``--full`` says
    so before allocating anything."""
    main = launch_serve.main if launcher == "serve" else launch_train.main
    arch = "kimi_k2_1t_a32b" if launcher == "serve" else "kimi-k2-1t-a32b"
    with pytest.raises(SystemExit, match="does not fit: 1044.9 B"):
        main(["--arch", arch, "--full", "--device", "cpu"])
