"""The MoE and VLM families of the port against the JAX reference: the
engine's programs, training and the launchers.

Bridged reference weights, seeded numpy inputs, f32 with JAX at "highest"
matmul precision: the engine's continuation and decode programs route each
row alone; ``lm_loss`` and its per-leaf gradients (vision prefix and M-RoPE
positions included); the paged engine's greedy tokens per ``req_id``
against the JAX ``Engine`` (FCFS and PARS, chunked prefill, prefix
caching) at capacity factor 4.0; the reference's padding-lane overwrite
(ROADMAP C3), which the port's engine does not copy; the decode step by
batch bucket, staged into its captured step and run eagerly, as the CPU
runs it (the real rows' tokens and logits of the unpadded step, padding
rows writing the null block alone, contiguous lanes' tokens, the
counters), dense and MoE; an MoE first chunk staged as its graph holds it
(the grid of shapes, padding lanes on the all-null table keeping the real
lanes' logits, K/V and drops, C3's dispatch included, the eager first
chunks' tokens, the counters); ``expert_rows`` and ``routed_slots``
against the rows the products ran and the real positions; and the
launchers (the MoE smoke config trains with its auxiliary losses;
``--full`` refuses what fits no device). The model half is in
``test_torch_moe.py``.
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
from repro_torch.serving.engine import Engine, decode_buckets, prefill_grid

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
    lg, cache, _ = tfm.forward_chunk(params, cfg, _t(chunk).long(),
                                     {**cache, "pos": pos})
    ld, _, _ = tfm.decode_step(params, cfg, cache, _t(step).long())
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


# ---------------------------------------------------------- decode buckets
@pytest.mark.parametrize("max_batch,buckets", [
    (64, [1, 2, 4, 8, 16, 24, 32, 40, 48, 56, 64]),
    (5, [1, 2, 4, 5]),
    (1, [1]),
])
def test_decode_buckets(max_batch, buckets):
    assert decode_buckets(max_batch) == buckets


def _graph_engine(arch, max_batch=8, *, paged=None):
    """An f32 smoke engine on the CPU, FCFS, 2048-token vocab."""
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    params = tfm.init_params(cfg, 0, device="cpu")
    return Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=max_batch),
                  cache_len=64, prompt_len=32, paged=paged,
                  record_tokens=True, device="cpu")


def _stage_decode(be, reqs, active, b):
    """Decode's staging of ``reqs`` (in slots ``active``) into bucket
    ``b``'s captured step; returns the step."""
    step = be._decode_shapes[b]
    step.stage([be._table(r, step.nb) for r in reqs],
               [[be._pos[r.req_id] for r in reqs]],
               be.slot_tokens[active][:, None])
    return step


def _staged(steps):
    """Spy on the staging of each of ``steps`` (a backend's table of
    captured steps): the list it fills, one (real rows, the shape's rows)
    a staging."""
    seen = []
    for step in steps.values():
        def stage(tables, cols, tokens=None, step=step, inner=step.stage):
            seen.append((len(tables), step.rows))
            inner(tables, cols, tokens)
        step.stage = stage
    return seen


@pytest.mark.parametrize("arch", ["llama3_2_3b", "olmoe_1b_7b"])
def test_bucketed_step_matches_the_unpadded_step(arch):
    """Three decode-ready rows padded to buckets 4 and 8: the real rows'
    logits equal the unpadded eager step's at f32 tolerance (the same
    greedy tokens, the same MoE drops), the padding rows write no pool
    block but the null block, and a bucket staged with fewer rows than
    before pads the rest again."""
    eng = _graph_engine(arch)
    be = eng.backend
    eng.submit([Request(i, _words(5 + 4 * i, f"g{i}"), 0.0, 32, 9)
                for i in range(3)])
    eng.core.tick()                   # admission, prefill, one decode step
    active = [i for i, r in enumerate(be.slot_req) if r is not None]
    reqs = [be.slot_req[i] for i in active]
    assert len(reqs) == 3
    # the null block zeroed: the tick's own decode step padded its rows
    be.k_pool[:, be._null_block] = 0
    be.v_pool[:, be._null_block] = 0
    pools = (be.k_pool.clone(), be.v_pool.clone())

    def changed_blocks():
        diff = (be.k_pool != pools[0]) | (be.v_pool != pools[1])
        return set(diff.flatten(2).any(-1).any(0).nonzero()[:, 0].tolist())

    def restore():
        be.k_pool.copy_(pools[0])
        be.v_pool.copy_(pools[1])

    poss = np.asarray([be._pos[r.req_id] for r in reqs], np.int32)
    logits, _, aux = tfm.decode_step(be.params, be.cfg,
                                     be._cache(reqs, poss),
                                     be.slot_tokens[active][:, None])
    written = changed_blocks()
    assert be._null_block not in written and written
    for b in (4, 8):
        restore()
        out, drops, held = _stage_decode(be, reqs, active, b).run()
        assert held is None            # every expert held
        assert out.shape[0] == b
        torch.testing.assert_close(out[:3], logits, atol=1e-5, rtol=1e-5)
        assert torch.equal(out[:3].argmax(-1), logits.argmax(-1))
        assert changed_blocks() == written | {be._null_block}
        if be.cfg.moe is None:
            assert drops is None
        else:
            assert torch.equal(drops[:3], aux["token_drops"])
    # staged again with fewer rows, the rest are padding rows again
    step = _stage_decode(be, reqs[:1], active[:1], 4)
    assert (step.tables[1:] == be._null_block).all()
    assert (step.columns[:, 1:] == 0).all()


@pytest.mark.parametrize("arch", ["llama3_2_3b", "olmoe_1b_7b"])
def test_bucketed_decode_serves_the_eager_tokens(arch):
    """A 7-request burst behind 5 slots (buckets 1, 2, 4, 5): the paged
    engine, whose every decode step is staged into the smallest bucket
    that holds it and runs that bucket's step (eagerly, on the CPU), gives
    the greedy tokens and MoE drops of contiguous lanes, which decode
    unpadded; the pad rows are counted, and no replay is, on the CPU or
    in lanes."""
    runs = {}
    for paged in (False, True):
        eng = _graph_engine(arch, max_batch=5, paged=paged)
        be = eng.backend
        eng.warmup()
        staged = _staged(be._decode_shapes)
        eng.submit([Request(i, _words(6 + 3 * i, f"r{i}"), 0.0, 32, 5 + i)
                    for i in range(7)])
        runs[paged] = ({r.req_id: r.generated_tokens for r in eng.run()},
                       be.dropped_slots)
        assert be.decode_steps > 0 and be.decode_graph_steps == 0
        if paged:
            assert be.decode_steps == len(staged)
            assert all(b == min(x for x in decode_buckets(5) if x >= n)
                       for n, b in staged)
            assert be.decode_pad_rows == sum(b - n for n, b in staged) > 0
        else:
            assert not staged and be.decode_pad_rows == 0
    assert runs[True] == runs[False]
    assert len(runs[True][0]) == 7
    if arch == "olmoe_1b_7b":
        assert runs[True][1] > 0


def test_contiguous_lanes_decode_eagerly():
    """Contiguous lanes (hymba's rings, or a dense model with
    ``paged=False``) build no captured step and decode eagerly, warmed or
    not."""
    for arch, paged in (("hymba_1_5b", None), ("llama3_2_3b", False)):
        eng = _graph_engine(arch, max_batch=3, paged=paged)
        be = eng.backend
        eng.warmup()
        eng.submit([Request(i, _words(6, f"c{i}"), 0.0, 32, 4)
                    for i in range(3)])
        assert len(eng.run()) == 3
        assert not be.paged and not be._decode_shapes
        assert not be._first_shapes
        assert be.decode_steps > 0 and be.decode_graph_steps == 0
        assert be.decode_pad_rows == 0


# ---------------------------------------------------- first-chunk graphs
BUCKETS = [8, 16, 32, 64, 128, 256, 512, 1024]


@pytest.mark.parametrize("budget,buckets,max_batch,shapes", [
    (512, BUCKETS, 64, 28),
    (512, BUCKETS, 16, 25),
    (None, BUCKETS, 64, 0),
    (64, [8, 16, 32], 8, 9),
])
def test_prefill_grid(budget, buckets, max_batch, shapes):
    """Every first chunk's (lanes, tokens) under a budget: the whole
    prompts of each bucket up to it, and the budget itself where a longer
    bucket is cut to it, at every power of two of lanes up to
    ``max_batch`` whose tokens fit the budget; largest first. No budget,
    no grid."""
    grid = prefill_grid(budget, buckets, max_batch)
    assert len(grid) == len(set(grid)) == shapes
    for lanes, width in grid:
        assert lanes & (lanes - 1) == 0 and lanes <= max_batch
        assert lanes * width <= budget and width in buckets
    tokens = [lanes * width for lanes, width in grid]
    assert tokens == sorted(tokens, reverse=True)
    if budget == 512 and max_batch == 64:
        assert {w for _, w in grid} == set(BUCKETS[:-1])
        assert {lanes for lanes, w in grid if w == 8} == {
            1, 2, 4, 8, 16, 32, 64}


def test_prefill_grid_takes_the_budget_as_a_cut_prompt():
    """A budget that is no bucket is still a first chunk's length: the
    first cut of every longer prompt."""
    assert prefill_grid(24, [8, 16, 32], 4) == [(1, 24), (1, 16), (2, 8),
                                                (1, 8)]


def _first_chunk_engine(cfg, params, max_batch, chunk):
    return Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=max_batch),
                  cache_len=128, prompt_len=32, prefill_chunk_tokens=chunk,
                  record_tokens=True, device="cpu")


def _eager_first_chunks(be):
    """Empty ``be``'s table of first-chunk steps: every first chunk then
    takes the path of the shapes off the grid, an eager ``forward_seq``
    whose cache takes the real rows alone."""
    be._first_shapes.clear()


def test_padding_lanes_on_null_tables_keep_the_real_lanes():
    """C3's dispatch (three prompts padded to four lanes, at the published
    capacity factor, beside a one-lane bucket), staged into its captured
    step as its graph holds it: the padding lane's table is all null. The
    sampled logits, every pool block but the null one (which the padding
    lane alone writes) and the MoE drops equal the eager path's, whose
    cache takes the real rows alone; the drops are not zero, so the lanes
    couple."""
    jcfg, jparams, cfg, params = _bridged("olmoe_1b_7b")
    runs = {}
    for staged in (False, True):
        eng = _first_chunk_engine(cfg, params, 4, 128)
        be = eng.backend
        before = be.k_pool.clone(), be.v_pool.clone()
        if not staged:
            _eager_first_chunks(be)
        stagings = _staged(be._first_shapes)
        sampled = []
        sample = be._sample

        def recorded(logits):
            sampled.append(logits.clone())
            return sample(logits)
        be._sample = recorded
        eng.submit(_workload(Request)[:4])
        eng.core.tick()                     # admission, prefill, one decode
        null = be._null_block
        changed = ((be.k_pool != before[0]) | (be.v_pool != before[1]))
        runs[staged] = (sampled, be.k_pool[:, :null], be.v_pool[:, :null],
                        set(changed.flatten(2).any(-1).any(0).nonzero()[:, 0]
                            .tolist()), be.dropped_slots)
        assert be.prefill_dispatches == 2 and be.prefill_pad_lanes == 1
        assert be.prefill_graph_dispatches == 0
        assert sorted(stagings) == ([(1, 1), (3, 4)] if staged else [])
    (eager, k0, v0, w0, d0), (graph, k1, v1, w1, d1) = runs[False], runs[True]
    assert len(eager) == len(graph) == 3      # two first chunks, one decode
    assert all(torch.equal(e, g) for e, g in zip(eager, graph))
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    assert null not in w0 and w1 == w0 | {null}
    assert d0 == d1 > 0


@pytest.mark.parametrize("arch,max_batch,chunk", [
    ("olmoe_1b_7b", 4, 16),
    ("moonlight_16b_a3b", 4, 16),
    ("olmoe_1b_7b", 3, 32),
])
def test_first_chunk_replays_serve_the_eager_tokens(arch, max_batch, chunk):
    """A 9-request burst at the published capacity factor: staging each
    first chunk that lies on the grid into its captured step, and running
    the step as its graph would replay it, gives the greedy tokens and MoE
    drops of the eager first chunks. With 4 slots every first chunk is on
    the grid (a 32-token prompt's second half under a 16-token budget runs
    eagerly as a continuation); with 3 the first wave's three 8-token
    prompts pad to four lanes, more than the slots, and run eagerly."""
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    params = tfm.init_params(cfg, 0, device="cpu")
    runs = {}
    for staged in (False, True):
        eng = _first_chunk_engine(cfg, params, max_batch, chunk)
        be = eng.backend
        if not staged:
            _eager_first_chunks(be)
        stagings = _staged(be._first_shapes)
        words = [3, 5, 7, 20, 4, 12, 6, 25, 3] if chunk == 16 else [3] * 9
        eng.submit([Request(i, _words(n, f"f{i}"), 0.0, 32, 3 + i % 4)
                    for i, n in enumerate(words)])
        runs[staged] = ({r.req_id: r.generated_tokens for r in eng.run()},
                        be.dropped_slots)
        assert be.prefill_graph_dispatches == 0
        if not staged:
            assert not stagings
        elif max_batch == 4:
            assert len(stagings) == be.prefill_dispatches
            assert be.extend_dispatches > 0
        else:
            assert 0 < len(stagings) < be.prefill_dispatches
    assert runs[True] == runs[False]
    assert len(runs[True][0]) == 9


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonlight_16b_a3b"])
def test_expert_rows_count_the_rows_the_products_ran(arch, monkeypatch):
    """A 9-request burst under chunks of 16 (first chunks on the grid,
    continuation chunks, decode buckets): ``expert_rows`` is the sum of the
    rows that every MoE dispatch's expert products ran, a decode step's
    one row an expert for each row of its bucket; ``routed_slots`` is k
    slots for every real prompt and output position in each MoE layer."""
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    params = tfm.init_params(cfg, 0, device="cpu")
    eng = _first_chunk_engine(cfg, params, 4, 16)
    be = eng.backend
    buckets = _staged(be._decode_shapes)
    ran = []                        # (tokens a row, per_row, expert rows)
    apply_moe, bmm = tfm.apply_moe, torch.bmm

    def spied(p, x, moe_cfg, act, *, per_row=False, routing=None):
        rows = []
        monkeypatch.setattr(torch, "bmm", lambda a, b: rows.append(
            a.shape[0] * a.shape[1]) or bmm(a, b))
        try:
            out = apply_moe(p, x, moe_cfg, act, per_row=per_row,
                            routing=routing)
        finally:
            monkeypatch.setattr(torch, "bmm", bmm)
        ran.append((x.shape[1], per_row, rows[0]))
        return out
    monkeypatch.setattr(tfm, "apply_moe", spied)
    words = [3, 5, 7, 20, 4, 12, 6, 25, 3]
    eng.submit([Request(i, _words(n, f"x{i}"), 0.0, 32, 3 + i % 4)
                for i, n in enumerate(words)])
    fin = eng.run()
    assert len(fin) == 9 and be.extend_dispatches > 0
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    layers = cfg.num_layers - getattr(cfg, "first_k_dense", 0)
    assert be.expert_rows == sum(rows for *_, rows in ran)
    decode = [rows for s, per_row, rows in ran if per_row and s == 1]
    assert len(decode) == layers * be.decode_steps
    assert sum(decode) == layers * e * sum(b for _, b in buckets)
    assert be.routed_slots == layers * k * sum(
        len(be._prompt_ids(r)) + r.true_length - 1 for r in fin)


@pytest.mark.parametrize("arch,chunk,shapes", [
    ("olmoe_1b_7b", 16, 3),
    ("olmoe_1b_7b", None, 0),
    ("llama3_2_3b", 16, 0),
])
def test_first_chunks_run_eagerly_on_the_cpu(arch, chunk, shapes):
    """On the CPU a warmed engine captures nothing: its first chunks run
    eagerly, staged or not, and ``prefill_graph_dispatches`` stays 0. Only
    an MoE model with a budget builds the grid's captured steps."""
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    params = tfm.init_params(cfg, 0, device="cpu")
    eng = _first_chunk_engine(cfg, params, 4, chunk)
    be = eng.backend
    eng.warmup()
    assert len(be._first_shapes) == shapes
    assert all(s.graph is None for s in (*be._first_shapes.values(),
                                         *be._decode_shapes.values()))
    stagings = _staged(be._first_shapes)
    eng.submit([Request(i, _words(4 + 5 * i, f"c{i}"), 0.0, 32, 3)
                for i in range(5)])
    assert len(eng.run()) == 5
    assert be.prefill_dispatches > 0 and be.prefill_graph_dispatches == 0
    assert len(stagings) == (be.prefill_dispatches if shapes else 0)
    assert be.capture_seconds == be.prefill_capture_seconds == 0.0


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
