"""The port's CUDA kernels and engine on the card.

Every test here needs a CUDA card and skips without one (the kernels build
and run only there). The module imports neither JAX nor the JAX package, so
it also runs on the card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX). Each kernel is held
against its plain PyTorch version on the same inputs: attention f32 with
TF32 off at 2e-5 and bf16 at 2e-2 (paged and ring decode at their split edges, with
aliased tables and slots bitwise; the bf16 prefill kernel's bare wgmma tile
against ``torch.matmul``), chunked linear attention at 5e-4 (its final state
included, at the log-decay contract's edge too; its bare 3xTF32 tile against
``torch.matmul`` at 1e-5); the engine on the card emits the same greedy tokens
as on the CPU, and its contiguous lanes the same tokens as its paged pool;
the admission benchmark's twin launches the paged path's two kernels and
no other.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.kernels.flash_decode.ops import (paged_decode_attention,
                                                  paged_decode_attention_plain,
                                                  ring_decode_attention,
                                                  ring_decode_attention_plain,
                                                  ring_split_geometry,
                                                  split_geometry)
from repro_torch.kernels.flash_prefill.ops import (flash_attention,
                                                   flash_attention_plain,
                                                   wgmma_tile_check)
from repro_torch.kernels.rwkv6_chunk.ops import (linear_attention,
                                                 tf32_tile_check)
from repro_torch.models.linear_attn import chunked_linear_attention
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only "
                    "there (chip_smoke.py holds them on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=dev, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain(cuda, dtype):
    b, kh, g, dh, bs, mb = 4, 8, 3, 128, 16, 8
    rng = np.random.default_rng(7)
    n = b * mb + 1
    tables = torch.as_tensor(np.stack([rng.permutation(n)[:mb]
                                       for _ in range(b)]),
                             dtype=torch.int32, device=cuda)
    lengths = torch.tensor([mb * bs, 1, 0, 77], dtype=torch.int32,
                           device=cuda)
    args = (_randn(rng, (b, kh * g, dh), dtype, cuda),
            _randn(rng, (n, bs, kh, dh), dtype, cuda),
            _randn(rng, (n, bs, kh, dh), dtype, cuda), tables, lengths)
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(),
                               paged_decode_attention_plain(*args).float(),
                               **TOL[dtype])


def _paged_args(rng, dtype, dev, b, kh, g, dh, bs, mb, lengths):
    n = b * mb + 1
    tables = torch.as_tensor(np.stack([rng.permutation(n)[:mb]
                                       for _ in range(b)]),
                             dtype=torch.int32, device=dev)
    return (_randn(rng, (b, kh * g, dh), dtype, dev),
            _randn(rng, (n, bs, kh, dh), dtype, dev),
            _randn(rng, (n, bs, kh, dh), dtype, dev), tables,
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mb", [32, 10])     # 10: not a multiple of a split
def test_paged_decode_kernel_at_split_edges(cuda, dtype, mb):
    """Lengths 0 (every split walked, fully masked), 1, one split, a split
    boundary -1/+1, three splits and the full table."""
    bs = 16
    split = split_geometry(bs, mb)[0] * bs
    lengths = [0, 1, split - 1, split, split + 1,
               min(3 * split, mb * bs) - 3, mb * bs - 1, mb * bs]
    args = _paged_args(np.random.default_rng(21), dtype, cuda, 8, 8, 3, 128,
                       bs, mb, lengths)
    torch.testing.assert_close(
        paged_decode_attention(*args).float(),
        paged_decode_attention_plain(*args).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_aliased_tables_over_three_splits(cuda, dtype):
    bs, mb = 16, 16
    entries = split_geometry(bs, mb)[0]
    q, kp, vp, tables, _ = _paged_args(np.random.default_rng(22), dtype,
                                       cuda, 4, 8, 3, 128, bs, mb, [0] * 4)
    tables[1, :3 * entries] = tables[0, :3 * entries]
    q[1] = q[0]
    lengths = torch.full((4,), 3 * entries * bs - 5, dtype=torch.int32,
                         device=cuda)
    out = paged_decode_attention(q, kp, vp, tables, lengths)
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_wgmma_tile_matches_matmul(cuda, dh):
    """The bf16 prefill kernel's swizzled tiles and wgmma descriptors, bare:
    S = Q K^T and O = bf16(S) V on one 64-row tile."""
    rng = np.random.default_rng(dh)
    q, k, v = (_randn(rng, (64, dh), "bfloat16", cuda) for _ in range(3))
    s, o = wgmma_tile_check(q, k, v)
    ref = torch.matmul(q.float(), k.float().T)
    torch.testing.assert_close(s, ref, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(o, torch.matmul(ref.to(torch.bfloat16).float(),
                                               v.float()),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("sq", [8, 40, 128])
def test_prefill_kernel_shapes_and_offsets(cuda, dtype, dh, sq):
    """First chunks (q_start 0 over their own keys) and continuation chunks
    (per-row offsets over a longer lane)."""
    b, h, kh = 3, 8, 2
    rng = np.random.default_rng(sq + dh)
    q = _randn(rng, (b, h, sq, dh), dtype, cuda)
    for starts, skv in (([0, 0, 0], sq), ([0, 37, 131], sq + 140)):
        k = _randn(rng, (b, kh, skv, dh), dtype, cuda)
        v = _randn(rng, (b, kh, skv, dh), dtype, cuda)
        st = torch.tensor(starts, dtype=torch.int32, device=cuda)
        torch.testing.assert_close(
            flash_attention(q, k, v, st, st + sq).float(),
            flash_attention_plain(q, k, v, st, st + sq).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_kernel_hymba_group_and_window(cuda, dtype):
    """Hymba's G=5, dh=64 under a window of 48 shorter than the prompt."""
    rng = np.random.default_rng(23)
    q = _randn(rng, (2, 25, 128, 64), dtype, cuda)
    k = _randn(rng, (2, 5, 128, 64), dtype, cuda)
    v = _randn(rng, (2, 5, 128, 64), dtype, cuda)
    zero = torch.zeros(2, dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        flash_attention(q, k, v, zero, zero + 128, window=48).float(),
        flash_attention_plain(q, k, v, zero, zero + 128, window=48).float(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_kernel_matches_plain(cuda, dtype):
    b, h, kh, sq, skv, dh = 3, 24, 8, 40, 104, 128
    rng = np.random.default_rng(4)
    q = _randn(rng, (b, h, sq, dh), dtype, cuda)
    k = _randn(rng, (b, kh, skv, dh), dtype, cuda)
    v = _randn(rng, (b, kh, skv, dh), dtype, cuda)
    starts = torch.tensor([0, 17, 64], dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, starts, starts + sq)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q, k, v, starts,
                                           starts + sq).float(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kh,g,dh,w,window", [(5, 5, 64, 256, 200),
                                              (8, 3, 128, 96, None)])
def test_ring_decode_kernel_matches_plain(cuda, dtype, kh, g, dh, w, window):
    """Rows fresh, part-full and wrapped many times over, in shuffled
    slots, with and without a window."""
    rng = np.random.default_rng(8)
    pos = torch.tensor([0, 5, w - 1, w, 3 * w + 17], dtype=torch.int32,
                       device=cuda)
    slots = torch.tensor([4, 0, 2, 5, 1], dtype=torch.int32, device=cuda)
    args = (_randn(rng, (5, kh * g, dh), dtype, cuda),
            _randn(rng, (6, kh, w, dh), dtype, cuda),
            _randn(rng, (6, kh, w, dh), dtype, cuda), slots, pos)
    before = ring_decode_attention.launches
    out = ring_decode_attention(*args, window=window)
    assert ring_decode_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(),
        ring_decode_attention_plain(*args, window=window).float(),
        **TOL[dtype])


def _ring_args(rng, dtype, dev, kh, g, dh, w, pos):
    b = len(pos)
    return (_randn(rng, (b, kh * g, dh), dtype, dev),
            _randn(rng, (b + 1, kh, w, dh), dtype, dev),
            _randn(rng, (b + 1, kh, w, dh), dtype, dev),
            torch.arange(b, 0, -1, dtype=torch.int32, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w,window", [(256, None), (256, 100), (1024, 1024),
                                      (64, 40)])
def test_ring_decode_kernel_at_split_edges(cuda, dtype, w, window):
    """pos 0, 1, 63, 64, 65 (unwrapped), W-1, W, W+63, 3W+64 (wrapped),
    with a window shorter than the lane and without one."""
    pos = [0, 1, 63, 64, 65, w - 1, w, w + 63, 3 * w + 64]
    args = _ring_args(np.random.default_rng(w), dtype, cuda, 5, 5, 64, w,
                      pos)
    assert ring_split_geometry(w)[1] == -(-w // 64)
    torch.testing.assert_close(
        ring_decode_attention(*args, window=window).float(),
        ring_decode_attention_plain(*args, window=window).float(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_decode_kernel_aliased_slots_are_bitwise_equal(cuda, dtype):
    """Two rows reading one lane at one pos with one query (three splits,
    wrapped, under a window) give bitwise-equal outputs."""
    q, kl, vl, slots, pos = _ring_args(np.random.default_rng(24), dtype,
                                       cuda, 5, 5, 64, 192,
                                       [454, 5, 454, 900])
    q[2] = q[0]
    slots[2] = slots[0]
    out = ring_decode_attention(q, kl, vl, slots, pos, window=150)
    assert torch.equal(out[0], out[2])


def test_ring_decode_rejects_a_misaligned_lane(cuda):
    q, kl, vl, slots, pos = _ring_args(np.random.default_rng(25), "bfloat16",
                                       cuda, 2, 2, 64, 64, [3, 4])
    flat = torch.zeros(kl.numel() + 1, dtype=kl.dtype, device=cuda)
    odd = flat[1:].view(kl.shape)                  # 2 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        ring_decode_attention(q, odd, vl, slots, pos)


def test_tf32_tile_matches_matmul(cuda):
    """The chunked kernel's 3xTF32 products and fragment layouts, bare:
    S = A B^T, O = S C (S re-laid out from the accumulators) and
    U = A^T C on one 64 x 64 tile, against f32 torch.matmul."""
    rng = np.random.default_rng(26)
    a, b, c = (_randn(rng, (64, 64), "float32", cuda) / 8 for _ in range(3))
    s, o, u = tf32_tile_check(a, b, c)
    tol = dict(atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s, torch.matmul(a, b.T), **tol)
    torch.testing.assert_close(o, torch.matmul(s, c), **tol)
    torch.testing.assert_close(u, torch.matmul(a.T, c), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,dk", [("ssd", 16), ("rwkv", 64)])
def test_linear_attention_kernel_at_the_decay_edge(cuda, dtype, mode, dk):
    """Every step's log-decay at -1, the contract's edge: the decayed
    operands span e^+-64 within a chunk."""
    rng = np.random.default_rng(27)
    b, h, t, dv = 2, 3, 128, 64
    q = _randn(rng, (b, h, t, dk), dtype, cuda)
    k = _randn(rng, (b, h, t, dk), dtype, cuda)
    v = _randn(rng, (b, h, t, dv), dtype, cuda)
    lw = torch.full((b, h, t, dk if mode == "rwkv" else 1), -1.0,
                    device=cuda)
    u = (_randn(rng, (h, dk), "float32", cuda) * 0.1 if mode == "rwkv"
         else None)
    out, state = linear_attention(q, k, v, lw, u, mode=mode, chunk=64)
    ref, ref_state = chunked_linear_attention(q, k, v, lw, bonus=u,
                                              mode=mode, chunk_size=64)
    tol = dict(atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(state, ref_state, **tol)
    torch.testing.assert_close(out.float(), ref.float(),
                               **(tol if dtype == "float32"
                                  else TOL["bfloat16"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,dk,t", [("ssd", 16, 100), ("rwkv", 64, 128)])
def test_linear_attention_kernel_matches_plain(cuda, dtype, mode, dk, t):
    rng = np.random.default_rng(9)
    b, h, dv = 2, 3, 64
    q = _randn(rng, (b, h, t, dk), dtype, cuda)
    k = _randn(rng, (b, h, t, dk), dtype, cuda)
    v = _randn(rng, (b, h, t, dv), dtype, cuda)
    lw = -torch.rand(b, h, t, dk if mode == "rwkv" else 1, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
    u = (_randn(rng, (h, dk), "float32", cuda) * 0.1 if mode == "rwkv"
         else None)
    before = linear_attention.launches
    out, state = linear_attention(q, k, v, lw, u, mode=mode, chunk=64)
    assert linear_attention.launches == before + 1
    pad = (-t) % 64
    ref, ref_state = chunked_linear_attention(
        *(torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v, lw)),
        bonus=u, mode=mode, chunk_size=64)
    tol = dict(atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(state, ref_state, **tol)
    torch.testing.assert_close(out.float(), ref[:, :, :t].float(),
                               **(tol if dtype == "float32"
                                  else TOL["bfloat16"]))


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 48, device=cuda)           # head_dim 48
    k = torch.zeros(1, 2, 8, 48, device=cuda)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[:, :, None].expand(1, 4, 8, 48).contiguous(), k, k,
                        zero, zero + 8)
    with pytest.raises(ValueError, match="int32"):
        flash_attention(torch.zeros(1, 4, 8, 64, device=cuda),
                        torch.zeros(1, 2, 8, 64, device=cuda),
                        torch.zeros(1, 2, 8, 64, device=cuda),
                        zero.long(), zero + 8)


def _words(n, tag):
    return " ".join(f"{tag}w{j}" for j in range(n))


def test_engine_on_the_card_matches_the_cpu(cuda):
    """The smoke model in f32, chunked and prefix-cached: greedy tokens on
    the card (both kernels) equal the CPU run (plain versions)."""
    cfg = get_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                  vocab_size=2048)
    params = tfm.init_params(cfg, 0, device="cpu")

    def run(device, tree):
        shared = _words(24, "sys")
        reqs = [Request(i, shared + " " + _words(6, f"u{i}"), 0.0, 32, 4 + i)
                for i in range(4)]
        eng = Engine(cfg, tree, Scheduler(policy=fcfs(), max_batch=2),
                     cache_len=96, prompt_len=32, prefill_chunk_tokens=16,
                     prefix_caching=True, record_tokens=True, device=device)
        eng.submit(reqs)
        return {r.req_id: r.generated_tokens for r in eng.run()}

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    before = (paged_decode_attention.launches, flash_attention.launches)
    on_card = run(cuda, to(params, cuda))
    assert paged_decode_attention.launches > before[0]
    assert flash_attention.launches > before[1]
    assert on_card == run("cpu", params)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _serve(cfg, params, device, *, paged=None, cache_len=64, out_len=5):
    reqs = [Request(i, _words(6 + 3 * i, f"r{i}"), 0.0, 32, out_len + i)
            for i in range(5)]
    eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=3),
                 cache_len=cache_len, prompt_len=32, paged=paged,
                 record_tokens=True, device=device)
    eng.submit(reqs)
    return {r.req_id: r.generated_tokens for r in eng.run()}


def test_contiguous_engine_matches_paged_engine_on_the_card(cuda):
    """llama smoke in f32: contiguous lanes on the ring decode kernel emit
    the paged engine's greedy tokens, across a lane wrap (32-token prompts,
    up to 44 outputs, 64-row lanes)."""
    cfg = get_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                  vocab_size=2048)
    params = tfm.init_params(cfg, 0, device=cuda)
    before = ring_decode_attention.launches
    contiguous = _serve(cfg, params, cuda, paged=False, out_len=40)
    assert ring_decode_attention.launches > before
    assert contiguous == _serve(cfg, params, cuda, paged=True, out_len=40)


def test_hybrid_engine_on_the_card_matches_the_cpu(cuda):
    """hymba smoke in f32: all three kernels of its path launch, and the
    greedy tokens equal the CPU run's."""
    cfg = get_smoke_config("hymba_1_5b").replace(dtype="float32")
    params = tfm.init_params(cfg, 0, device="cpu")
    before = (ring_decode_attention.launches, linear_attention.launches,
              flash_attention.launches)
    on_card = _serve(cfg, _to(params, cuda), cuda, out_len=40)
    after = (ring_decode_attention.launches, linear_attention.launches,
             flash_attention.launches)
    assert all(a > b for a, b in zip(after, before))
    assert on_card == _serve(cfg, params, "cpu", out_len=40)


def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    """A CUDA operand that requires grad raises before any launch: the
    kernels have no backward."""
    q = torch.randn(1, 2, 8, 32, device=cuda, requires_grad=True)
    kv = torch.randn(1, 1, 8, 32, device=cuda)
    lens = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, kv, kv, torch.zeros_like(lens), lens)
    assert flash_attention.launches == before


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """llama smoke in f32 (TF32 off): one train step (chunked attention,
    remat, clipped Adam) on the card equals the CPU's: loss and grad norm
    at 1e-5 relative, new parameters at 1e-5."""
    from repro_torch.models import example_batch
    from repro_torch.training import Adam, cosine_schedule
    from repro_torch.training.train_loop import make_train_step

    cfg = get_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                  vocab_size=2048)
    params = tfm.init_params(cfg, 0, device="cpu")
    batch = example_batch(cfg, 2, 24, 3, device="cpu")
    out = {}
    for device in (cuda, "cpu"):        # the CPU step updates params in place
        opt = Adam(learning_rate=cosine_schedule(3e-4, 5, 20), clip_norm=1.0)
        p = _to(params, device)
        p, _, m = make_train_step(cfg, opt, remat="full")(
            p, opt.init(p), {k: v.to(device) for k, v in batch.items()})
        out[str(device)] = (_to(p, "cpu"), float(m["loss"]),
                            float(m["grad_norm"]))
    (p_cpu, *m_cpu), (p_card, *m_card) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-5)

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)
    for a, b in zip(leaves(p_card), leaves(p_cpu)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["sequential", "bucketed"])
def test_admission_twin_on_the_card_launches_the_paged_kernels(cuda, mode):
    """``benchmarks.torch_prefill_admission`` at smoke width (f32, batch 4,
    two bursts) on the card: the CPU run's dispatches, every request
    finished, the prefill kernel in each layer of each prefill dispatch,
    paged decode in each layer of each decode step, no other kernel."""
    from benchmarks.torch_prefill_admission import run

    on_card = run(batch=4, reps=2, device=cuda)[mode]
    on_cpu = run(batch=4, reps=2, device="cpu")[mode]
    layers = get_smoke_config("llama3_2_3b").num_layers
    counts = on_card["launches"]
    assert on_card["dispatches"] == on_cpu["dispatches"]
    assert on_card["finished"] == 8
    assert counts["flash_attention"] == layers * on_card["dispatches"]
    assert counts["paged_decode_attention"] > 0
    assert counts["paged_decode_attention"] % layers == 0
    assert counts["ring_decode_attention"] == counts["linear_attention"] == 0
    assert not any(on_cpu["launches"].values())
