"""The slices as a whole: the port's engine against the JAX engine.

With bridged weights, the port's ``Engine`` (greedy) emits the same tokens
per ``req_id`` as the JAX ``Engine`` on the workload of
``tests/test_paged_decode.py``, with the same dispatch and prefix counters:
the f32 ``llama3_2_3b`` smoke config paged and with contiguous lanes
(``paged=False``), in all four (chunked prefill, prefix caching)
combinations, and the f32 ``hymba_1_5b`` smoke config (hybrid, sliding
window, contiguous lanes that wrap as rings). Paged prefix hits copy no KV;
contiguous hits copy the reference's count of tokens; every block is
released at the end.
"""
import jax
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.scheduler.policies import fcfs as jax_fcfs
from repro.core.scheduler.request import Request as JaxRequest
from repro.core.scheduler.scheduler import Scheduler as JaxScheduler
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as JaxEngine
from repro.serving.kv_cache import BlockAllocator as JaxBlockAllocator
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.launch import serve as launch_serve
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import BlockAllocator

torch.set_num_threads(1)


def _bridged(arch):
    jcfg = jax_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def setup():
    return _bridged("llama3_2_3b")


@pytest.fixture(scope="module")
def hymba():
    return _bridged("hymba_1_5b")


def _words(n, tag):
    return " ".join(f"{tag}w{j}" for j in range(n))


def _workload(req_cls, solo_len=5):
    shared = _words(24, "sys")
    reqs = [req_cls(i, shared + " " + _words(6, f"u{i}"), 0.0, 32, 4 + i)
            for i in range(4)]
    return reqs + [req_cls(10 + i, _words(10, f"solo{i}"), 0.0, 32, solo_len)
                   for i in range(2)]


def _run(port, setup, *, chunk=None, caching=False, blocks=None, reqs=None,
         cache_len=96, prompt_len=32, max_batch=4, paged=True):
    jcfg, jparams, cfg, params = setup
    if port:
        eng = Engine(cfg, params, Scheduler(policy=fcfs(),
                                            max_batch=max_batch),
                     cache_len=cache_len, prompt_len=prompt_len,
                     prefill_chunk_tokens=chunk, prefix_caching=caching,
                     allocator=BlockAllocator(blocks, 16) if blocks else None,
                     paged=paged, record_tokens=True, device="cpu")
    else:
        eng = JaxEngine(jcfg, jparams, JaxScheduler(policy=jax_fcfs(),
                                                    max_batch=max_batch),
                        cache_len=cache_len, prompt_len=prompt_len,
                        paged=paged, prefill_chunk_tokens=chunk,
                        prefix_caching=caching,
                        allocator=(JaxBlockAllocator(blocks, 16) if blocks
                                   else None),
                        record_tokens=True)
    eng.submit(reqs if reqs is not None
               else _workload(Request if port else JaxRequest))
    fin = eng.run()
    return {r.req_id: r.generated_tokens for r in fin}, eng


COUNTERS = ("prefill_dispatches", "extend_dispatches", "prefill_requests",
            "prefix_installs", "prefix_tokens_copied")


def _assert_same_counters(eng, jeng):
    for counter in COUNTERS:
        assert getattr(eng.backend, counter) == getattr(jeng.backend,
                                                        counter), counter


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("chunk,caching", [
    (None, False),            # plain bucketed admission + decode
    (16, False),              # chunked prefill
    (None, True),             # prefix caching (a hit resumes mid-prompt)
    (16, True),               # both composed
])
def test_engine_tokens_match_jax_engine(setup, chunk, caching, paged):
    ref, jeng = _run(False, setup, chunk=chunk, caching=caching, paged=paged)
    out, eng = _run(True, setup, chunk=chunk, caching=caching, paged=paged)
    assert out == ref
    assert len(out) == 6 and all(len(t) for t in out.values())
    _assert_same_counters(eng, jeng)
    assert eng.allocator.used_blocks == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_prefix_hits_are_zero_copy_and_match_jax(setup, paged):
    """A donor request commits the shared prefix; three later requests hit
    it: ``prefix_installs`` counts the claims. Paged hits copy no KV;
    contiguous hits copy the prefix out of the fragment store, as many
    tokens as the reference copies."""
    shared = _words(30, "sys")

    def two_phase(port):
        jcfg, jparams, cfg, params = setup
        req = Request if port else JaxRequest
        if port:
            eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=4),
                         cache_len=96, prompt_len=64, prefix_caching=True,
                         paged=paged, record_tokens=True, device="cpu")
        else:
            eng = JaxEngine(jcfg, jparams,
                            JaxScheduler(policy=jax_fcfs(), max_batch=4),
                            cache_len=96, prompt_len=64, paged=paged,
                            prefix_caching=True, record_tokens=True)
        eng.submit([req(0, shared + " donor", 0.0, 40, 4)])
        eng.run()
        eng.submit([req(10 + i, shared + " " + _words(4, f"u{i}"), 0.0, 40, 4)
                    for i in range(3)])
        eng.run()
        return {r.req_id: r.generated_tokens for r in eng.finished}, eng

    ref, jeng = two_phase(False)
    out, eng = two_phase(True)
    assert out == ref
    _assert_same_counters(eng, jeng)
    assert eng.backend.prefix_installs == 3
    assert (eng.backend.prefix_tokens_copied == 0) == paged
    hits = {r.req_id: r.cached_prefix_tokens for r in eng.finished}
    assert hits[0] == 0 and all(hits[10 + i] > 0 for i in range(3))
    assert eng.allocator.used_blocks == 0


def test_hymba_engine_matches_jax_engine_over_wrapping_rings(hymba):
    """Hymba smoke (window 64) at ``cache_len=64``: contiguous lanes, and
    the two solo requests decode past the 64-row ring (16-token bucket plus
    70 outputs). The JAX engine cannot run ``cache_len`` above the window
    (its prefill builds unclamped lanes), so 64 is the largest shared
    setting."""
    def run(port):
        return _run(port, hymba, cache_len=64, paged=None,
                    reqs=_workload(Request if port else JaxRequest, 70))

    ref, jeng = run(False)
    out, eng = run(True)
    assert not eng.backend.paged and eng.backend.lanes["k"].shape[3] == 64
    assert out == ref
    assert max(len(t) for t in out.values()) == 70
    _assert_same_counters(eng, jeng)
    assert eng.allocator.used_blocks == 0


def test_hymba_lanes_clamp_to_the_window(hymba):
    """``cache_len`` above the window serves the same tokens: the lanes are
    ``min(cache_len, window)`` wide in prefill and decode alike."""
    runs = {n: _run(True, hymba, cache_len=n, paged=None,
                    reqs=_workload(Request, 70)) for n in (64, 128)}
    assert runs[128][1].backend.lanes["k"].shape[3] == 64
    assert runs[128][0] == runs[64][0]


def test_recompute_preemption_under_kv_budget_matches_jax(setup):
    """A budget too small for every request: admission waits on KV blocks,
    and the tokens still match the JAX engine's."""
    def constrained(port):
        req = Request if port else JaxRequest
        reqs = [req(i, _words(8, f"p{i}"), 0.0, 16, 12) for i in range(5)]
        return _run(port, setup, blocks=6, cache_len=32, prompt_len=16,
                    max_batch=5, reqs=reqs)

    ref, _ = constrained(False)
    out, eng = constrained(True)
    assert out == ref
    assert eng.allocator.used_blocks == 0


def test_incremental_reservation_grow_preempts_and_recovers(setup):
    _jcfg, _jparams, cfg, params = setup
    reqs = [Request(i, _words(8, f"r{i}"), 0.0, 16, 24) for i in range(6)]
    eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=6),
                 cache_len=48, prompt_len=16, allocator=BlockAllocator(8, 16),
                 kv_reservation="incremental", record_tokens=True,
                 device="cpu")
    eng.submit(reqs)
    fin = eng.run()
    assert len(fin) == 6
    assert all(r.tokens_done == r.true_length == len(r.generated_tokens)
               for r in fin)
    assert sum(r.grow_preemptions or 0 for r in fin) > 0
    assert eng.allocator.used_blocks == 0


def test_engine_refuses_what_the_slice_does_not_port(setup, hymba,
                                                     monkeypatch):
    _jcfg, _jparams, cfg, params = setup
    sched = Scheduler(policy=fcfs(), max_batch=2)
    with pytest.raises(NotImplementedError, match="without frames"):
        Engine(cfg.replace(family="audio"), params, sched, device="cpu")
    hcfg, hparams = hymba[2], hymba[3]
    for kw in (dict(prefill_chunk_tokens=16), dict(prefix_caching=True)):
        with pytest.raises(ValueError, match="attention-family"):
            Engine(hcfg, hparams, sched, cache_len=64, device="cpu", **kw)
    with pytest.raises(ValueError, match="paged KV needs"):
        Engine(hcfg, hparams, sched, cache_len=64, paged=True, device="cpu")
    with pytest.raises(ValueError, match="bounded"):
        Engine(cfg, params, sched, cache_len=64, prompt_len=16,
               allocator=BlockAllocator.unbounded(16), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params, sched)                 # device defaults to cuda


@pytest.mark.parametrize("arch", ["llama3_2_3b", "hymba_1_5b", "rwkv6_7b",
                                  "olmoe_1b_7b", "qwen2_vl_72b"])
def test_launcher_serves_on_cpu(capsys, arch):
    rep = launch_serve.main(["--arch", arch, "--device", "cpu",
                             "--requests", "6", "--batch", "2",
                             "--max-len", "8"])
    assert rep.n_requests == 6
    assert "tok/s" in capsys.readouterr().out
