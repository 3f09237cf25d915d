"""The real-engine halves of the port's serving twins against the JAX
benchmarks, at the reference's ``--smoke`` sizes on its f32
``llama3_2_3b`` smoke config, from weights bridged from
``tfm.init_params(PRNGKey(0), cfg)`` (the reference benches' own weights).

- Every engine run of ``paged_decode``, ``chunked_prefill`` and
  ``prefix_caching`` emits the reference's greedy tokens per ``req_id``
  (the calibration run included): both ``Engine.run`` methods record the
  tokens of each run in order.
- The counters no wall clock decides equal the reference's: prefix
  installs and tokens copied, hit rate and prefill tokens saved, and the
  tight budget's grow failures and preemptions.
- ``run_kernel``'s inputs, in the reference's pool layout, give the
  port's plain paged decode the reference oracle's output (2e-5, f32);
  the kernel microbench's plain versions match the reference's
  ``attention_chunked`` and ``decode_attention`` (2e-5 in f32, 2e-2 in
  bf16) and its token recurrence ``rwkv6_recurrent_ref`` (5e-4) at
  reduced shapes.
- ``examples/torch_serve_e2e.py --device cpu`` runs with JAX, the JAX
  package and ``benchmarks.common`` blocked.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.chunked_prefill as ref_chunked
import benchmarks.paged_decode as ref_paged
import benchmarks.prefix_caching as ref_prefix
import benchmarks.torch_chunked_prefill as port_chunked
import benchmarks.torch_kernel_bench as port_kernels
import benchmarks.torch_paged_decode as port_paged
import benchmarks.torch_prefix_caching as port_prefix
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_decode.ref import flash_decode_paged_ref
from repro.kernels.rwkv6_chunk.ref import rwkv6_recurrent_ref
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving.engine import Engine as RefEngine
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.kernels.flash_decode.ops import paged_decode_attention_plain
from repro_torch.kernels.flash_prefill.ops import flash_attention_plain
from repro_torch.models.linear_attn import chunked_linear_attention
from repro_torch.serving.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

# the reference mains' --smoke arguments of each run_real
REAL_SMOKE = {
    "paged_decode": (ref_paged, port_paged,
                     dict(shared_words=16, n_warm=2, prompt_len=32,
                          n_tight=4)),
    "chunked_prefill": (ref_chunked, port_chunked,
                        dict(n_bg=2, bg_len=40, n_burst=2, prompt_len=32,
                             chunk=8)),
    "prefix_caching": (ref_prefix, port_prefix,
                       dict(n_warm=3, shared_words=20, unique_words=6,
                            prompt_len=32)),
}


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                   vocab_size=2048)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return bridge.params_from_flat(_flatten(jparams), device="cpu")


def _recording(monkeypatch, cls, runs):
    """Make ``cls.run`` append each run's tokens per ``req_id`` to
    ``runs``."""
    run = cls.run

    def recorded(self, *a, **kw):
        out = run(self, *a, **kw)
        runs.append({r.req_id: list(r.generated_tokens)
                     for r in self.finished})
        return out

    monkeypatch.setattr(cls, "run", recorded)


@pytest.mark.parametrize("name", REAL_SMOKE)
def test_real_half_tokens_and_counters_equal_the_reference(
        monkeypatch, bridged, name):
    ref, port, kw = REAL_SMOKE[name]
    # the reference's warm-up compiles its shape grid, nothing more
    monkeypatch.setattr(RefEngine, "warmup", lambda self: 0.0)
    ref_runs, port_runs = [], []
    _recording(monkeypatch, RefEngine, ref_runs)
    _recording(monkeypatch, Engine, port_runs)
    expected = ref.run_real(**kw)
    got = port.run_real(**kw, device="cpu", params=bridged)
    assert len(port_runs) == len(ref_runs) >= 2
    for i, (r, p) in enumerate(zip(ref_runs, port_runs)):
        assert p == r, f"run {i}"
    assert got["identical_outputs"] is expected["identical_outputs"] is True
    assert got["width"] == "smoke" and got["dtype"] == "float32"
    if name == "paged_decode":
        for key in ("prefix_installs", "prefix_tokens_copied"):
            assert got[key] == expected[key]
        assert got["tight_budget"]["grow_failures"] == \
            expected["tight_budget"]["grow_failures"] > 0
        assert got["tight_budget"]["grow_preemptions"] == \
            expected["tight_budget"]["grow_preemptions"] > 0
    elif name == "prefix_caching":
        for mode in ("uncached", "cached"):
            for key in ("prefix_installs", "prefix_tokens_copied",
                        "n_requests"):
                assert got[mode][key] == expected[mode][key], (mode, key)
        np.testing.assert_equal(
            [got["cached"][k] for k in ("prefix_hit_rate",
                                        "prefill_tokens_saved")],
            [expected["cached"][k] for k in ("prefix_hit_rate",
                                             "prefill_tokens_saved")])
    # on the CPU the wrappers run their plain versions: no launch
    for run in ("paged", "contiguous", "tight_budget", "calibration",
                "unchunked", "chunked", "uncached", "cached"):
        if run in got:
            assert not any(got[run]["launches"].values()), run


def test_run_kernel_inputs_match_the_reference_oracle():
    q, kp, vp, tables, lengths = port_paged.kernel_inputs(b=2, mb=4,
                                                          device="cpu")
    b, h, dh = q.shape
    kh = kp.shape[2]
    got = paged_decode_attention_plain(q, kp, vp, tables, lengths)
    ref = flash_decode_paged_ref(
        jnp.asarray(q.numpy()).reshape(b, kh, h // kh, dh),
        jnp.asarray(kp.permute(0, 2, 1, 3).numpy()),   # (N, KH, bs, dh)
        jnp.asarray(vp.permute(0, 2, 1, 3).numpy()),
        jnp.asarray(tables.numpy()), jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(b, h, dh),
                               atol=2e-5, rtol=2e-5)
    assert (tables[:, 0] == 0).all()                # the aliased block
    out = port_paged.run_kernel(b=2, mb=4, iters=1, device="cpu")
    assert out["max_abs_err"] == 0.0 and out["us_per_call"] is None


TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _np(x):
    return np.asarray(x.float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bench_plain_prefill_matches_reference_attention(dtype):
    q, k, v, q_start, kv_len = port_kernels.prefill_inputs(
        1, 4, 2, 96, 32, dtype=dtype, device="cpu")
    got = flash_attention_plain(q, k, v, q_start, kv_len)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    s = q.shape[2]
    pos = jnp.broadcast_to(jnp.arange(s)[None], (1, s))
    ref = jattn.attention_chunked(*(jnp.asarray(_np(x).transpose(0, 2, 1, 3),
                                                jdt) for x in (q, k, v)),
                                  pos, pos)
    np.testing.assert_allclose(_np(got), np.asarray(
        ref, np.float32).transpose(0, 2, 1, 3), atol=TOLS[dtype],
        rtol=TOLS[dtype])
    np.testing.assert_allclose(_np(port_kernels.prefill_model(q, k, v)),
                               _np(got), atol=TOLS[dtype], rtol=TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_bench_plain_ring_decode_matches_reference(dtype):
    from repro_torch.kernels.flash_decode.ops import \
        ring_decode_attention_plain

    args = port_kernels.decode_inputs(2, 4, 2, 32, 256, dtype=dtype,
                                      device="cpu")
    q, kl, vl, _, pos = args
    got = ring_decode_attention_plain(*args)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jattn.decode_attention(
        jnp.asarray(_np(q), jdt),
        jnp.asarray(_np(kl).transpose(0, 2, 1, 3), jdt),   # (B, W, KH, dh)
        jnp.asarray(_np(vl).transpose(0, 2, 1, 3), jdt),
        int(pos[0]))                                       # W - 1
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def test_kernel_bench_plain_rwkv_matches_reference_recurrence():
    q, k, v, lw, u = port_kernels.rwkv_inputs(1, 2, 128, 16, device="cpu")
    out, state = chunked_linear_attention(q, k, v, lw, bonus=u, mode="rwkv",
                                          chunk_size=64)
    ref_out = rwkv6_recurrent_ref(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, lw, u)), mode="rwkv")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=5e-4, rtol=5e-4)
    # the twin's counterpart on the CPU: the port's token recurrence
    rec_out, rec_state = port_kernels.rwkv_recurrence(q, k, v, lw, u)
    np.testing.assert_allclose(rec_out.numpy(), np.asarray(ref_out),
                               atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(rec_state.numpy(), state.numpy(), atol=5e-4,
                               rtol=5e-4)


def test_serve_e2e_twin_runs_with_jax_and_reference_unavailable():
    example = ROOT / "examples" / "torch_serve_e2e.py"
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['benchmarks.common'] = None\n"
            "sys.argv = ['torch_serve_e2e.py', '--device', 'cpu',"
            " '--requests', '4', '--max-len', '8']\n"
            f"runpy.run_path({str(example)!r},"
            " run_name='__main__')\n"
            "assert not [m for m in sys.modules\n"
            "            if m.split('.')[0] in ('jax', 'repro')\n"
            "            and sys.modules[m] is not None]\n")
    # one intra-op thread: beside the other test workers, more only
    # oversubscribe the cores
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [line.split()[0] for line in proc.stdout.splitlines()
            if line.startswith("  ") and "avg=" in line]
    assert rows == ["fcfs", "pars", "oracle"]
    assert proc.stdout.count("admission: 4 prefills") == 3
