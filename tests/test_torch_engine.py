"""The slice as a whole: the port's paged engine against the JAX engine.

On the f32 ``llama3_2_3b`` smoke config with bridged weights, the port's
``Engine`` (paged, greedy) emits the same tokens per ``req_id`` as the JAX
``Engine`` on the workload of ``tests/test_paged_decode.py``, in all four
(chunked prefill, prefix caching) combinations, with the same dispatch
counts; prefix hits copy no KV; every block is released at the end.
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


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                   vocab_size=2048)
    cfg = get_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                  vocab_size=2048)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _words(n, tag):
    return " ".join(f"{tag}w{j}" for j in range(n))


def _workload(req_cls):
    shared = _words(24, "sys")
    reqs = [req_cls(i, shared + " " + _words(6, f"u{i}"), 0.0, 32, 4 + i)
            for i in range(4)]
    return reqs + [req_cls(10 + i, _words(10, f"solo{i}"), 0.0, 32, 5)
                   for i in range(2)]


def _run(port, setup, *, chunk=None, caching=False, blocks=None, reqs=None,
         cache_len=96, prompt_len=32, max_batch=4):
    jcfg, jparams, cfg, params = setup
    if port:
        eng = Engine(cfg, params, Scheduler(policy=fcfs(),
                                            max_batch=max_batch),
                     cache_len=cache_len, prompt_len=prompt_len,
                     prefill_chunk_tokens=chunk, prefix_caching=caching,
                     allocator=BlockAllocator(blocks, 16) if blocks else None,
                     record_tokens=True, device="cpu")
    else:
        eng = JaxEngine(jcfg, jparams, JaxScheduler(policy=jax_fcfs(),
                                                    max_batch=max_batch),
                        cache_len=cache_len, prompt_len=prompt_len,
                        paged=True, prefill_chunk_tokens=chunk,
                        prefix_caching=caching,
                        allocator=(JaxBlockAllocator(blocks, 16) if blocks
                                   else None),
                        record_tokens=True)
    eng.submit(reqs if reqs is not None
               else _workload(Request if port else JaxRequest))
    fin = eng.run()
    return {r.req_id: r.generated_tokens for r in fin}, eng


@pytest.mark.parametrize("chunk,caching", [
    (None, False),            # plain bucketed admission + decode
    (16, False),              # chunked prefill
    (None, True),             # prefix caching (a hit resumes mid-prompt)
    (16, True),               # both composed
])
def test_engine_tokens_match_jax_engine(setup, chunk, caching):
    ref, jeng = _run(False, setup, chunk=chunk, caching=caching)
    out, eng = _run(True, setup, chunk=chunk, caching=caching)
    assert out == ref
    assert len(out) == 6 and all(len(t) for t in out.values())
    for counter in ("prefill_dispatches", "extend_dispatches",
                    "prefill_requests", "prefix_installs",
                    "prefix_tokens_copied"):
        assert getattr(eng.backend, counter) == getattr(jeng.backend,
                                                        counter), counter
    assert eng.allocator.used_blocks == 0


def test_prefix_hits_are_zero_copy_and_match_jax(setup):
    """A donor request commits the shared prefix; three later requests hit
    it: ``prefix_installs`` counts the claims, no KV token is copied."""
    shared = _words(30, "sys")

    def two_phase(port):
        jcfg, jparams, cfg, params = setup
        req = Request if port else JaxRequest
        if port:
            eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=4),
                         cache_len=96, prompt_len=64, prefix_caching=True,
                         record_tokens=True, device="cpu")
        else:
            eng = JaxEngine(jcfg, jparams,
                            JaxScheduler(policy=jax_fcfs(), max_batch=4),
                            cache_len=96, prompt_len=64, paged=True,
                            prefix_caching=True, record_tokens=True)
        eng.submit([req(0, shared + " donor", 0.0, 40, 4)])
        eng.run()
        eng.submit([req(10 + i, shared + " " + _words(4, f"u{i}"), 0.0, 40, 4)
                    for i in range(3)])
        eng.run()
        return {r.req_id: r.generated_tokens for r in eng.finished}, eng

    ref, _ = two_phase(False)
    out, eng = two_phase(True)
    assert out == ref
    assert eng.backend.prefix_installs == 3
    assert eng.backend.prefix_tokens_copied == 0
    hits = {r.req_id: r.cached_prefix_tokens for r in eng.finished}
    assert hits[0] == 0 and all(hits[10 + i] > 0 for i in range(3))
    assert eng.allocator.used_blocks == 0


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


def test_engine_refuses_what_the_slice_does_not_port(setup, monkeypatch):
    _jcfg, _jparams, cfg, params = setup
    sched = Scheduler(policy=fcfs(), max_batch=2)
    with pytest.raises(NotImplementedError, match="ROADMAP items A5 and B3"):
        Engine(cfg, params, sched, paged=False, device="cpu")
    with pytest.raises(ValueError, match="bounded"):
        Engine(cfg, params, sched, cache_len=64, prompt_len=16,
               allocator=BlockAllocator.unbounded(16), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params, sched)                 # device defaults to cuda


def test_launcher_serves_on_cpu(capsys):
    rep = launch_serve.main(["--device", "cpu", "--requests", "6",
                             "--batch", "2", "--max-len", "8"])
    assert rep.n_requests == 6
    assert "tok/s" in capsys.readouterr().out
