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
no other; a decode graph's replay equals the eager step bitwise at its
bucket, a warmed engine (graphs) serves the greedy tokens of one never
warmed (eager), and no garbage collection runs during a capture; the
latent (MLA) decode kernel and the prefill kernel's (192, 128) instance at
Moonlight's widths against their plain versions, and a latent decode
graph's replay equal to the eager step bitwise; an MoE first chunk's graph
(OLMoE and Moonlight) equal to today's eager ``forward_seq`` bitwise at every
shape of its grid, its padding lanes writing the null block alone, a warmed
engine's burst (first chunks replayed, each replay a span) equal to an
unwarmed one's, one shape staged twice in one unbucketed prefill, and no
collection during those captures; an MoE decode step's replay at buckets
1, 8 and 64 equal to the eager step, whose expert products run one row
an expert a row, and a served window's ``expert_rows``, ``routed_slots``
and MoE drops as counted from its shapes and from capacity-wide rows;
the prefill kernel without the causal mask and ring decode over
encoder lanes equal unmasked attention; Whisper through ``build()`` gives
the CPU's logits with exact launch counts; the hybrid, SSM and
encoder-decoder families' train steps equal the CPU's.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch import trace
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
from repro_torch.serving.engine import Engine, decode_buckets, prefill_grid

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
@pytest.mark.parametrize("sq", [200, 64, 33])
def test_prefill_kernel_without_the_causal_mask(cuda, dtype, sq):
    """``causal=False`` (an encoder's self-attention, cross-attention onto
    its rows): every query row sees all 200 keys, Sq = Skv or not, the last
    query and key tiles partial."""
    b, h, skv, dh = 2, 6, 200, 64
    rng = np.random.default_rng(7)
    q = _randn(rng, (b, h, sq, dh), dtype, cuda)
    k = _randn(rng, (b, h, skv, dh), dtype, cuda)
    v = _randn(rng, (b, h, skv, dh), dtype, cuda)
    zero = torch.zeros(b, dtype=torch.int32, device=cuda)
    full = zero + skv
    torch.testing.assert_close(
        flash_attention(q, k, v, zero, full, causal=False).float(),
        flash_attention_plain(q, k, v, zero, full, causal=False).float(),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_decode_kernel_over_cross_lanes_sees_every_row(cuda, dtype):
    """At ``pos = W - 1`` without a window every lane row counts: ring
    decode over an encoder's 200-row lanes (4 splits, the last of 8 rows)
    equals unmasked attention over them."""
    b, kh, dh, w = 3, 6, 64, 200
    rng = np.random.default_rng(8)
    q = _randn(rng, (b, kh, dh), dtype, cuda)
    lanes_k = _randn(rng, (b + 1, kh, w, dh), dtype, cuda)
    lanes_v = _randn(rng, (b + 1, kh, w, dh), dtype, cuda)
    slots = torch.tensor([3, 0, 2], dtype=torch.int32, device=cuda)
    pos = torch.full((b,), w - 1, dtype=torch.int32, device=cuda)
    out = ring_decode_attention(q, lanes_k, lanes_v, slots, pos)
    zero = torch.zeros(b, dtype=torch.int32, device=cuda)
    ref = flash_attention_plain(q[:, :, None], lanes_k[slots.long()],
                                lanes_v[slots.long()], zero, zero + w,
                                causal=False)[:, :, 0]
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


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


def test_whisper_bundle_on_the_card_matches_the_cpu(cuda):
    """whisper smoke in f32 through ``build()``: prefill and four greedy
    decode steps on the card give the CPU's logits (1e-4) and tokens; the
    prefill launches the prefill kernel once per encoder layer and twice
    per decoder layer (self, cross), each decode step ring decode twice per
    decoder layer, and nothing else."""
    from repro_torch.models import build

    cfg = get_smoke_config("whisper_tiny").replace(dtype="float32")
    bundle = build(cfg)
    params = bundle.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    frames = torch.randn(2, cfg.encoder_seq_len, cfg.d_model,
                         generator=gen) * 0.02
    runs = {}
    for device in ("cpu", cuda):
        tree = _to(params, device)
        before = (flash_attention.launches, ring_decode_attention.launches,
                  paged_decode_attention.launches, linear_attention.launches)
        lg, cache = bundle.prefill(tree, tokens.to(device), 16,
                                   frames=frames.to(device))
        logits, nxt = [lg[:, -1]], lg[:, -1].argmax(-1)
        for _ in range(4):
            lg, cache = bundle.decode_step(tree, cache, nxt[:, None])
            logits.append(lg)
            nxt = lg.argmax(-1)
        after = (flash_attention.launches, ring_decode_attention.launches,
                 paged_decode_attention.launches, linear_attention.launches)
        runs[str(device)] = (torch.stack(logits, 1).cpu(),
                             [a - b for a, b in zip(after, before)])
    (cpu_logits, cpu_launches), (card_logits, card_launches) = (
        runs["cpu"], runs[str(cuda)])
    assert cpu_launches == [0, 0, 0, 0]
    assert card_launches == [cfg.encoder_layers + 2 * cfg.num_layers,
                             4 * 2 * cfg.num_layers, 0, 0]
    torch.testing.assert_close(card_logits, cpu_logits, atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(card_logits.argmax(-1), cpu_logits.argmax(-1))


@pytest.mark.parametrize("arch", ["hymba_1_5b", "rwkv6_7b", "whisper_tiny"])
def test_family_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Smoke configs in f32 (TF32 off): one train step on the plain route
    (no kernel launches) on the card against the CPU's: loss at 1e-5
    relative, grad norm at 1e-3 (RWKV-6's f32 step is conditioned at about
    that through its per-head group norms; the card and CPU runs of
    ``chip_smoke.py`` phase 8 are held to an f64 step for that reason)."""
    from repro_torch.models import example_batch
    from repro_torch.training import Adam
    from repro_torch.training.train_loop import make_train_step

    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = tfm.init_params(cfg, 0, device="cpu")
    batch = example_batch(cfg, 2, 32, 3, device="cpu")
    out = {}
    for device in (cuda, "cpu"):
        opt = Adam(learning_rate=1e-3, clip_norm=1.0)
        p = _to(params, device)
        before = (flash_attention.launches, linear_attention.launches,
                  ring_decode_attention.launches)
        _, _, m = make_train_step(cfg, opt, remat="dots")(
            p, opt.init(p), {k: v.to(device) for k, v in batch.items()})
        assert (flash_attention.launches, linear_attention.launches,
                ring_decode_attention.launches) == before
        out[str(device)] = (float(m["loss"]), float(m["grad_norm"]))
    np.testing.assert_allclose(out[str(cuda)][0], out["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(out[str(cuda)][1], out["cpu"][1], rtol=1e-3)


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


def _graph_engine(cfg, params, device, max_batch=8):
    return Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=max_batch),
                  cache_len=64, prompt_len=32, record_tokens=True,
                  device=device)


def _captured(shapes):
    """The shapes of a backend's table of captured steps that hold a
    graph, in the table's order."""
    return [shape for shape, step in shapes.items() if step.graph is not None]


def _stage_decode(be, reqs, active, b):
    """Decode's staging of ``reqs`` (in slots ``active``) into bucket
    ``b``'s captured step; returns the step."""
    step = be._decode_shapes[b]
    step.stage([be._table(r, step.nb) for r in reqs],
               [[be._pos[r.req_id] for r in reqs]],
               be.slot_tokens[active][:, None])
    return step


def _watch(shapes, seen):
    """Note in ``seen``, at each run of a step of ``shapes``' (captures
    included), whether a capture is under way and the collector on."""
    for step in shapes.values():
        def forward(s, inner=step.forward):
            seen.append((torch.cuda.is_current_stream_capturing(),
                         gc.isenabled()))
            return inner(s)
        step.forward = forward


@pytest.mark.parametrize("arch", ["llama3_2_3b", "olmoe_1b_7b"])
def test_decode_graph_replay_is_the_eager_step_bitwise(cuda, arch):
    """Three decode-ready rows of the f32 smoke model: at every bucket of
    ``max_batch`` 8, the bucket's replay gives the logits, MoE drops and
    pool (null block aside, where padding rows race) of the same
    bucket's step run eagerly, bit for bit; a replay adds the paged
    kernel's calls its graph holds, one a layer."""
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    params = tfm.init_params(cfg, 0, device=cuda)
    eng = _graph_engine(cfg, params, cuda)
    be = eng.backend
    eng.warmup()
    assert sorted(_captured(be._decode_shapes)) == decode_buckets(8) == [
        1, 2, 4, 8]
    eng.submit([Request(i, _words(5 + 4 * i, f"g{i}"), 0.0, 32, 9)
                for i in range(3)])
    eng.core.tick()                   # admission, prefill, one decode step
    active = [i for i, r in enumerate(be.slot_req) if r is not None]
    reqs = [be.slot_req[i] for i in active]
    pools = (be.k_pool.clone(), be.v_pool.clone())
    real = slice(0, be._null_block)
    for b in decode_buckets(8):
        n = min(b, len(reqs))
        out = {}
        for how in ("eager", "graph"):
            be.k_pool.copy_(pools[0])
            be.v_pool.copy_(pools[1])
            step = _stage_decode(be, reqs[:n], active[:n], b)
            before = paged_decode_attention.launches
            logits, drops = (step.forward(step) if how == "eager"
                             else step.run())
            assert paged_decode_attention.launches == before + cfg.num_layers
            torch.cuda.synchronize()
            out[how] = (logits.clone(),
                        None if drops is None else drops.clone(),
                        be.k_pool[:, real].clone(), be.v_pool[:, real].clone())
        for e, g in zip(out["eager"], out["graph"]):
            assert (e is None and g is None) or torch.equal(e, g)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "olmoe_1b_7b"])
def test_warmed_engine_serves_the_eager_tokens(cuda, arch):
    """A 7-request paged burst behind 5 slots in f32: warmed, every decode
    step replays a graph and the greedy tokens and MoE drops equal the
    never-warmed engine's, which runs the same bucket's step eagerly."""
    cfg = get_smoke_config(arch).replace(dtype="float32", vocab_size=2048)
    params = tfm.init_params(cfg, 0, device=cuda)
    runs = {}
    for warm in (False, True):
        eng = _graph_engine(cfg, params, cuda, max_batch=5)
        if warm:
            eng.warmup()
        eng.submit([Request(i, _words(6 + 3 * i, f"r{i}"), 0.0, 32, 5 + i)
                    for i in range(7)])
        fin = eng.run()
        be = eng.backend
        runs[warm] = ({r.req_id: r.generated_tokens for r in fin},
                      be.dropped_slots)
        assert be.decode_steps > 0
        assert be.decode_graph_steps == (be.decode_steps if warm else 0)
    assert runs[True] == runs[False]
    assert len(runs[True][0]) == 7


def test_no_collection_runs_during_a_capture(cuda):
    """A dead engine's graphs are cyclic garbage (an engine and its core
    refer to each other); a collection during a capture would destroy them,
    which invalidates the capture. With collections due at every
    allocation, warming a second engine captures with the collector off,
    and turns it back on."""
    cfg = get_smoke_config("olmoe_1b_7b").replace(dtype="float32",
                                                  vocab_size=2048)
    params = tfm.init_params(cfg, 0, device=cuda)
    _graph_engine(cfg, params, cuda).warmup()       # now garbage
    eng = _graph_engine(cfg, params, cuda)
    be = eng.backend
    seen = []
    _watch(be._decode_shapes, seen)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng.warmup()
    finally:
        gc.set_threshold(*thresholds)
    assert sorted(_captured(be._decode_shapes)) == decode_buckets(8)
    assert (True, False) in seen and (True, True) not in seen
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# Latent attention (MLA, Moonlight-16B-A3B's widths)
# ---------------------------------------------------------------------------
def _latent_args(rng, dtype, dev, b, mb, lengths, bs=16, h=16, kd=576):
    pool = _randn(rng, (b * mb + 1, bs, kd), dtype, dev)
    tables = torch.as_tensor(rng.permutation(b * mb).reshape(b, mb),
                             dtype=torch.int32, device=dev)
    q = _randn(rng, (b, h, kd), dtype, dev)
    return q, pool, tables, torch.as_tensor(lengths, dtype=torch.int32,
                                            device=dev)


@pytest.mark.parametrize("mb", [4, 10])   # one split; three, the last short
def test_latent_decode_kernel_matches_plain(cuda, mb):
    """The latent decode kernel at Moonlight's shape (16 heads over 576-wide
    rows, V their first 512, scale 1/sqrt(192)) in bf16 against its plain
    version, ragged lengths (a fully masked row among them) over shuffled
    blocks; two rows on one table give bitwise-equal outputs (fixed-order
    merge); f32 is refused (tensor-core products)."""
    from repro_torch.kernels.flash_decode.ops import (
        latent_decode_attention, latent_decode_attention_plain)
    dtype = "bfloat16"
    rng = np.random.default_rng(31 + mb)
    w = mb * 16
    lengths = [1, 17, w - 3, w, 0, 40 % w + 1]
    q, pool, tables, lens = _latent_args(rng, dtype, cuda, 6, mb, lengths)
    tables[5] = tables[1]
    lens[5] = lens[1]
    q[5] = q[1]
    scale = 192 ** -0.5
    got = latent_decode_attention(q, pool, tables, lens, 512, scale)
    want = latent_decode_attention_plain(q, pool, tables, lens, 512, scale)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got[5], got[1])
    assert got.shape == (6, 16, 512)
    with pytest.raises(ValueError, match="bfloat16"):
        latent_decode_attention(q.float(), pool.float(), tables, lens, 512,
                                scale)


@pytest.mark.parametrize("sq,q_start,kv_len", [(40, [0, 0], [40, 40]),
                                               (128, [72, 0], [200, 128])])
def test_prefill_kernel_mla_instance_matches_plain(cuda, sq, q_start, kv_len):
    """The prefill kernel's (192, 128) instance in bf16: queries and keys of
    192 columns, values and outputs of 128, first chunks and a continuation
    at an offset over a longer lane, against the plain version; f32 with
    narrower values is refused."""
    rng = np.random.default_rng(41 + sq)
    b, h, skv = 2, 16, 200
    q = _randn(rng, (b, h, sq, 192), "bfloat16", cuda)
    k = _randn(rng, (b, h, skv, 192), "bfloat16", cuda)
    v = _randn(rng, (b, h, skv, 128), "bfloat16", cuda)
    qs = torch.as_tensor(q_start, dtype=torch.int32, device=cuda)
    kl = torch.as_tensor(kv_len, dtype=torch.int32, device=cuda)
    got = flash_attention(q, k, v, qs, kl)
    want = flash_attention_plain(q, k, v, qs, kl)
    assert got.shape == (b, h, sq, 128)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL["bfloat16"])
    with pytest.raises(ValueError, match="bfloat16 only"):
        flash_attention(q.float(), k.float(), v.float(), qs, kl)


def _latent_card_cfg():
    """Moonlight at its published widths with 2 layers (the dense one and
    one MoE layer), 8 experts and a 2,048-token vocabulary, in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    return get_config("moonlight_16b_a3b").replace(
        num_layers=2, vocab_size=2048,
        moe=MoEConfig(num_experts=8, top_k=6, expert_d_ff=1408))


def test_latent_decode_graph_replay_is_the_eager_step_bitwise(cuda):
    """Three decode-ready rows over the latent pool: at every bucket of
    ``max_batch`` 8, the bucket's replay gives the logits, MoE drops and
    latent pool (null block aside) of the same bucket's step run
    eagerly, bit for bit; a replay adds the latent kernel's calls its graph
    holds, one a layer, and the paged GQA kernel's none."""
    from repro_torch.kernels.flash_decode.ops import latent_decode_attention
    cfg = _latent_card_cfg()
    params = tfm.init_params(cfg, 0, device=cuda)
    eng = _graph_engine(cfg, params, cuda)
    be = eng.backend
    eng.warmup()
    assert be.v_pool is None and be.k_pool.shape[-1] == 576
    assert sorted(_captured(be._decode_shapes)) == decode_buckets(8)
    eng.submit([Request(i, _words(5 + 4 * i, f"m{i}"), 0.0, 32, 9)
                for i in range(3)])
    eng.core.tick()
    active = [i for i, r in enumerate(be.slot_req) if r is not None]
    reqs = [be.slot_req[i] for i in active]
    pool = be.k_pool.clone()
    real = slice(0, be._null_block)
    paged = paged_decode_attention.launches
    for b in decode_buckets(8):
        n = min(b, len(reqs))
        out = {}
        for how in ("eager", "graph"):
            be.k_pool.copy_(pool)
            step = _stage_decode(be, reqs[:n], active[:n], b)
            before = latent_decode_attention.launches
            logits, drops = (step.forward(step) if how == "eager"
                             else step.run())
            assert latent_decode_attention.launches == \
                before + cfg.num_layers
            torch.cuda.synchronize()
            out[how] = (logits.clone(), drops.clone(),
                        be.k_pool[:, real].clone())
        for e, g in zip(out["eager"], out["graph"]):
            assert torch.equal(e, g)
    assert paged_decode_attention.launches == paged


# ---------------------------------------------------------------------------
# First-chunk graphs (MoE prefill)
# ---------------------------------------------------------------------------
def _first_chunk_model(arch, device):
    """OLMoE's smoke config in f32, or Moonlight's two-layer card config
    in bf16 (its prefill kernel instance is bf16 only)."""
    cfg = (_latent_card_cfg() if arch == "moonlight_16b_a3b" else
           get_smoke_config(arch).replace(dtype="float32", vocab_size=2048))
    return cfg, tfm.init_params(cfg, 0, device=device)


def _first_chunk_engine(cfg, params, device, prompt_len=64):
    """8 slots, chunks of at most 64 tokens: a grid of 10 shapes."""
    return Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=8),
                  cache_len=2 * prompt_len, prompt_len=prompt_len,
                  prefill_chunk_tokens=64, record_tokens=True, device=device)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonlight_16b_a3b"])
def test_first_chunk_graph_replay_is_the_eager_forward_bitwise(cuda, arch):
    """At every shape of the grid, real rows padded with replicas of lane
    0: the replay gives today's eager ``forward_seq`` (tables for the real
    rows alone) bit for bit, in every lane's last logits and MoE drops and
    in every pool block but the null one, which only the padding lanes
    write; a replay adds one prefill kernel call a layer."""
    cfg, params = _first_chunk_model(arch, cuda)
    eng = _first_chunk_engine(cfg, params, cuda)
    be = eng.backend
    eng.warmup()
    shapes = prefill_grid(64, be.bucket_lens(), 8)
    assert _captured(be._first_shapes) == shapes and len(shapes) == 10
    rng = np.random.default_rng(5)
    pools = [p.clone() for p in be._pools().values()]
    null = be._null_block

    def restore():
        for p, saved in zip(be._pools().values(), pools):
            p.copy_(saved)

    def written():
        diff = sum((p != saved).flatten(2).any(-1).any(0).long()
                   for p, saved in zip(be._pools().values(), pools))
        return set(diff.nonzero()[:, 0].tolist())

    for lanes, width in shapes:
        n = 1 if lanes <= 2 else lanes // 2 + 1
        group = [Request(100 + j, "", 0.0, width, 2) for j in range(n)]
        lengths = rng.integers(width // 2 + 1, width + 1, n).tolist()
        tokens = np.zeros((lanes, width), np.int64)
        for j, (req, m) in enumerate(zip(group, lengths)):
            eng.allocator.allocate(req.req_id, width)
            be._slot_of[req.req_id] = j
            tokens[j, :m] = rng.integers(1, cfg.vocab_size, m)
        tokens[n:] = tokens[0]
        out = {}
        restore()
        nb = -(-width // 16)
        logits, _, aux = tfm.forward_seq(
            be.params, cfg, torch.as_tensor(tokens, device=cuda),
            cache=be._cache(group, np.zeros(n, np.int32), nb))
        torch.cuda.synchronize()
        out["eager"] = (logits[:, -1].clone(), aux["token_drops"].clone())
        eager_blocks = written()
        eager_pools = [p[:, :null].clone() for p in be._pools().values()]
        restore()
        step = be._first_shapes[lanes, width]
        step.stage([be._table(r, step.nb) for r in group],
                   [lengths, [be._slot_of[r.req_id] for r in group]], tokens)
        lens, slots = step.columns[:, :n]
        before = flash_attention.launches
        logits, drops = step.run()
        assert flash_attention.launches == before + cfg.num_layers
        torch.cuda.synchronize()
        out["graph"] = (logits.clone(), drops.clone())
        assert lens.tolist() == lengths and slots.tolist() == list(range(n))
        for e, g in zip(out["eager"], out["graph"]):
            assert torch.equal(e, g), (lanes, width)
        for p, e in zip(be._pools().values(), eager_pools):
            assert torch.equal(p[:, :null], e), (lanes, width)
        blocks = {b for req in group
                  for b in eng.allocator.block_table(req.req_id)}
        assert eager_blocks and eager_blocks <= blocks
        assert written() == eager_blocks | ({null} if lanes > n else set())
        for req in group:
            eng.allocator.free(req.req_id)
            del be._slot_of[req.req_id]


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonlight_16b_a3b"])
def test_warmed_engine_serves_the_eager_first_chunks(cuda, arch):
    """A 14-request burst behind 8 slots, prompts up to 120 tokens under
    chunks of 64: warmed, every first chunk replays a graph (the second
    half of a 128-token prompt runs eagerly as a continuation), and the
    tokens and MoE drops equal those of an engine never warmed whose first
    chunks all take the eager path of the shapes off the grid; the
    prefill kernel launches once a layer a dispatch, replays counted, each
    a ``backend.replay`` span (in ``backend.prefill`` or
    ``backend.decode``)."""
    cfg, params = _first_chunk_model(arch, cuda)
    runs = {}
    for warm in (False, True):
        eng = _first_chunk_engine(cfg, params, cuda, prompt_len=128)
        be = eng.backend
        if warm:
            eng.warmup()
        else:
            be._first_shapes.clear()
        flash_attention.launches = 0
        eng.submit([Request(i, _words(3 + 9 * i, f"p{i}"), 0.0, 128,
                            3 + i % 5) for i in range(14)])
        trace.enable()
        try:
            fin = eng.run()
            rec = trace.records()
        finally:
            trace.disable()
            trace.reset()
        runs[warm] = ({r.req_id: r.generated_tokens for r in fin},
                      be.dropped_slots)
        assert be.extend_dispatches > 0
        assert flash_attention.launches == cfg.num_layers * (
            be.prefill_dispatches + be.extend_dispatches)
        assert be.prefill_graph_dispatches == (be.prefill_dispatches
                                               if warm else 0)
        assert be.decode_graph_steps == (be.decode_steps if warm else 0)
        replays = [rec[s.parent].name for s in rec
                   if s.name == "backend.replay"]
        assert replays.count("backend.prefill") == \
            be.prefill_graph_dispatches
        assert replays.count("backend.decode") == be.decode_graph_steps
        assert len(replays) == (be.prefill_graph_dispatches
                                + be.decode_graph_steps)
    assert runs[True] == runs[False]
    assert len(runs[True][0]) == 14


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonlight_16b_a3b"])
def test_one_shape_staged_twice_in_one_prefill(cuda, arch):
    """Unbucketed prefill sends one request a dispatch, every one of shape
    (1, ``prompt_len``), on the grid: a step's four first chunks stage the
    same captured step four times in one ``_prefill`` before it
    synchronises, each staging from the third on finding the copy before
    it queued behind a replay, and waiting for it to read the pinned twin.
    Replayed, the greedy tokens and MoE drops equal the eager first
    chunks' (off the grid), unwarmed and unstaged."""
    cfg, params = _first_chunk_model(arch, cuda)
    runs = {}
    for warm in (False, True):
        eng = Engine(cfg, params, Scheduler(policy=fcfs(), max_batch=8),
                     cache_len=64, prompt_len=16, bucketed=False,
                     prefill_chunk_tokens=64, record_tokens=True,
                     device=cuda)
        be = eng.backend
        assert list(be._first_shapes) == [(4, 16), (2, 16), (1, 16)]
        if warm:
            eng.warmup()
        else:
            be._first_shapes.clear()
        per_prefill = []
        prefill = be.prefill

        def counted(chunks, now):
            before = be.prefill_graph_dispatches
            out = prefill(chunks, now)
            per_prefill.append(be.prefill_graph_dispatches - before)
            return out
        be.prefill = counted
        eng.submit([Request(i, _words(3 + i, f"u{i}"), 0.0, 16,
                            3 + i % 4) for i in range(8)])
        fin = eng.run()
        runs[warm] = ({r.req_id: r.generated_tokens for r in fin},
                      be.dropped_slots)
        assert be.prefill_graph_dispatches == (be.prefill_dispatches
                                               if warm else 0)
        if warm:
            assert max(per_prefill) == 4
    assert runs[True] == runs[False]
    assert len(runs[True][0]) == 8


def test_no_collection_runs_during_a_first_chunk_capture(cuda):
    """With collections due at every allocation and a dead engine's graphs
    waiting as garbage, warming an engine captures every first-chunk
    graph with the collector off and runs no collection during any
    capture, and turns the collector back on."""
    cfg, params = _first_chunk_model("olmoe_1b_7b", cuda)
    _first_chunk_engine(cfg, params, cuda).warmup()     # now garbage
    eng = _first_chunk_engine(cfg, params, cuda)
    be = eng.backend
    seen, collections = [], []
    _watch(be._first_shapes, seen)

    def on_collection(phase, _info):
        if phase == "start":
            collections.append(torch.cuda.is_current_stream_capturing())
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(on_collection)
    try:
        eng.warmup()
    finally:
        gc.callbacks.remove(on_collection)
        gc.set_threshold(*thresholds)
    assert _captured(be._first_shapes) == prefill_grid(64, be.bucket_lens(),
                                                       8)
    assert seen.count((True, False)) == len(be._first_shapes)
    assert (True, True) not in seen and True not in collections
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# Expert rows sized to the group (MoE decode: one row an expert)
# ---------------------------------------------------------------------------
def _moe_rows(monkeypatch, seen):
    """Note in ``seen`` the rows of each eager MoE dispatch's first expert
    product (a replay runs no Python, so it notes nothing)."""
    apply_moe, bmm = tfm.apply_moe, torch.bmm

    def spied(p, x, moe_cfg, act, *, per_row=False, routing=None):
        rows = []
        monkeypatch.setattr(torch, "bmm", lambda a, b: rows.append(
            a.shape[0] * a.shape[1]) or bmm(a, b))
        try:
            return apply_moe(p, x, moe_cfg, act, per_row=per_row,
                             routing=routing)
        finally:
            monkeypatch.setattr(torch, "bmm", bmm)
            seen.append(rows[0])
    monkeypatch.setattr(tfm, "apply_moe", spied)


def _moe_layers(cfg):
    return cfg.num_layers - getattr(cfg, "first_k_dense", 0)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonlight_16b_a3b"])
def test_moe_decode_replay_at_buckets_to_64_is_the_eager_step(
        cuda, arch, monkeypatch):
    """64 decode-ready rows of the OLMoE smoke model (f32) or Moonlight's
    two-layer card model (bf16): at buckets 1, 8 and 64 of ``max_batch``
    64, the replay gives the logits, greedy tokens and MoE drops of the
    same bucket's step run eagerly, bit for bit, and the eager step's
    expert products run E rows a MoE layer for each row of the bucket (one
    row an expert, not the capacity's 8)."""
    cfg, params = _first_chunk_model(arch, cuda)
    eng = _graph_engine(cfg, params, cuda, max_batch=64)
    be = eng.backend
    eng.warmup()
    assert sorted(_captured(be._decode_shapes)) == decode_buckets(64)
    eng.submit([Request(i, _words(3 + i % 13, f"b{i}"), 0.0, 32, 9)
                for i in range(64)])
    eng.core.tick()
    active = [i for i, r in enumerate(be.slot_req) if r is not None]
    reqs = [be.slot_req[i] for i in active]
    assert len(reqs) == 64
    pools = [p.clone() for p in be._pools().values()]
    real = slice(0, be._null_block)
    seen = []
    _moe_rows(monkeypatch, seen)
    for b in (1, 8, 64):
        out = {}
        for how in ("eager", "graph"):
            for p, saved in zip(be._pools().values(), pools):
                p.copy_(saved)
            step = _stage_decode(be, reqs[:b], active[:b], b)
            seen.clear()
            logits, drops = (step.forward(step) if how == "eager"
                             else step.run())
            torch.cuda.synchronize()
            assert seen == ([cfg.moe.num_experts * b] * _moe_layers(cfg)
                            if how == "eager" else [])
            out[how] = (logits.clone(), logits.argmax(-1), drops.clone(),
                        *(p[:, real].clone() for p in be._pools().values()))
        for e, g in zip(out["eager"], out["graph"]):
            assert torch.equal(e, g), b


# The MoE drops of ``_served_window`` (seed 0) as the engine counted them
# on an H100 with every group's expert rows as wide as its capacity (8 a
# decode row). Moonlight's card model (8 experts, top 6) has capacity 64
# at 64 tokens a group, so its first chunks drop nothing either.
WINDOW_DROPS = {"olmoe_1b_7b": 153, "moonlight_16b_a3b": 0}


def _served_window(cfg, params, device):
    """A warmed engine (8 slots, chunks of 64) serves a 14-request burst of
    prompts up to 64 tokens, every first chunk and decode step replayed.
    Returns the engine, the finished requests and, from spies on the
    stagings and on ``forward_chunk``, the decode steps' bucket rows, the
    first chunks' (lanes, tokens) and the continuation chunks' (rows,
    tokens)."""
    eng = _first_chunk_engine(cfg, params, device)
    be = eng.backend
    eng.warmup()
    decode, first, chunks = [], [], []
    for shapes, seen in ((be._decode_shapes, decode),
                         (be._first_shapes, first)):
        for step in shapes.values():
            def stage(tables, cols, tokens=None, step=step, seen=seen,
                      inner=step.stage):
                seen.append(step.rows if seen is decode
                            else tuple(step.tokens.shape))
                inner(tables, cols, tokens)
            step.stage = stage
    forward_chunk = tfm.forward_chunk

    def spied(params, cfg, tokens, cache, **kw):
        chunks.append(tuple(tokens.shape))
        return forward_chunk(params, cfg, tokens, cache, **kw)
    tfm.forward_chunk = spied
    try:
        eng.submit([Request(i, _words(4 + 5 * i, f"w{i}"), 0.0, 64,
                            3 + i % 5) for i in range(14)])
        fin = eng.run()
    finally:
        tfm.forward_chunk = forward_chunk
    assert len(fin) == 14
    assert be.decode_graph_steps == be.decode_steps == len(decode)
    assert be.prefill_graph_dispatches == be.prefill_dispatches == len(first)
    return eng, fin, decode, first, chunks


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonlight_16b_a3b"])
def test_served_window_counts_expert_rows_and_keeps_its_drops(cuda, arch):
    """Over a served window, ``expert_rows`` is E x bucket rows for each
    replayed decode step, and E x groups x min(C, tokens a group) for each
    first chunk (and continuation chunk, each row a dispatch), in every
    MoE layer; ``routed_slots`` is k for every real prompt and output
    position in every MoE layer; the MoE drops are those counted with
    capacity-wide rows: a one-token group drops nothing at either width,
    and first chunks keep their width."""
    cfg, params = _first_chunk_model(arch, cuda)
    eng, fin, decode, first, chunks = _served_window(cfg, params, cuda)
    be = eng.backend
    moe = cfg.moe
    e, k = moe.num_experts, moe.top_k

    def rows(groups, tg):       # E x groups x min(capacity, tg)
        cap = max(8, -(-int(tg * k * moe.capacity_factor / e) // 8) * 8)
        return e * groups * min(cap, tg)
    want = sum(rows(1, 1) * b for b in decode)
    for lanes, width in first:
        tg = min(moe.group_size, lanes * width)
        want += rows(lanes * width // tg, tg)
    for b, s in chunks:
        tg = min(moe.group_size, s)
        want += rows(b * s // tg, tg)
    layers = _moe_layers(cfg)
    assert be.expert_rows == layers * want
    assert be.routed_slots == layers * k * sum(
        len(be._prompt_ids(r)) + r.true_length - 1 for r in fin)
    assert be.dropped_slots == WINDOW_DROPS[arch]
