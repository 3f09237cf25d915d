"""The port's kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions, which are
held here against the Pallas kernels in interpret mode and their jnp oracles
(the tolerances of ``tests/test_kernels.py``: atol = rtol = 2e-5 in f32,
2e-2 in bf16, 5e-4 for chunked linear attention). The CUDA kernels
themselves are held against the plain versions on the card, by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro.kernels.flash_decode.ref import flash_decode_paged_ref
from repro.kernels.flash_prefill.ops import flash_attention as flash_pallas
from repro.kernels.flash_prefill.ref import flash_prefill_ref
from repro.kernels.rwkv6_chunk.ops import linear_attention_pallas
from repro.kernels.rwkv6_chunk.ref import rwkv6_recurrent_ref
from repro.models.attention import attention_naive as jax_attention_naive
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.attention import update_cache as jax_update_cache
from repro.models.linear_attn import \
    chunked_linear_attention as jax_chunked_linear_attention
from repro_torch.kernels.flash_decode.ops import (NEG_INF,
                                                  paged_decode_attention,
                                                  paged_decode_attention_plain,
                                                  ring_decode_attention,
                                                  ring_decode_attention_plain,
                                                  ring_split_geometry,
                                                  split_geometry)
from repro_torch.kernels.flash_prefill.ops import (flash_attention,
                                                   flash_attention_plain)
from repro_torch.kernels.moe_route.ops import (slot_positions,
                                               slot_positions_plain)
from repro_torch.kernels.rwkv6_chunk.ops import linear_attention
from repro_torch.models.attention import (attention_naive, gather_lane,
                                          prefill_cache, update_cache,
                                          write_paged)
from repro_torch.models.linear_attn import (MAX_LOG_DECAY,
                                            linear_attention_step)

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _tol(dtype):
    return BF16 if dtype == "bfloat16" else F32


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype="float32"):
    """numpy -> torch in ``dtype`` (bf16 rounds exactly as JAX's cast)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _pools_to_port(pool):
    """Reference pool (N, KH, bs, dh) -> port layout (N, bs, KH, dh)."""
    return np.ascontiguousarray(np.transpose(np.asarray(pool, np.float32),
                                             (0, 2, 1, 3)))


def _paged_inputs(seed, b, h, kh, bs, mb, dh, n_blocks=64):
    rng = np.random.default_rng(seed)
    k_pool = rng.standard_normal((n_blocks, kh, bs, dh), np.float32)
    v_pool = rng.standard_normal((n_blocks, kh, bs, dh), np.float32)
    q = rng.standard_normal((b, h, dh), np.float32)
    # shuffled tables; every sequence's first block is block 0 (aliasing)
    tables = np.stack([rng.permutation(n_blocks)[:mb] for _ in range(b)])
    tables[:, 0] = 0
    lengths = np.asarray([mb * bs - (i * 7) % (mb * bs - 1) if i else mb * bs
                          for i in range(b)], np.int32)
    return q, k_pool, v_pool, tables.astype(np.int32), lengths


def _port_paged(q, k_pool, v_pool, tables, lengths, dtype="float32"):
    return paged_decode_attention(
        _t(q, dtype), _t(_pools_to_port(k_pool), dtype),
        _t(_pools_to_port(v_pool), dtype), torch.from_numpy(tables),
        torch.from_numpy(lengths))


# ------------------------------------------------------------ paged decode
@pytest.mark.parametrize("b,h,kh,bs,mb,dh", [
    (2, 8, 2, 16, 8, 64),            # GQA group 4
    (1, 4, 4, 32, 4, 128),           # MHA
    (3, 4, 1, 16, 6, 32),            # MQA
])
def test_paged_decode_plain_matches_pallas_and_oracle(b, h, kh, bs, mb, dh):
    q, kp, vp, tables, lengths = _paged_inputs(7, b, h, kh, bs, mb, dh)
    out = _port_paged(q, kp, vp, tables, lengths).numpy()
    pallas = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True)
    ref = flash_decode_paged_ref(
        jnp.asarray(q).reshape(b, kh, h // kh, dh), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths)).reshape(b, h, dh)
    np.testing.assert_allclose(out, _np(pallas), **F32)
    np.testing.assert_allclose(out, _np(ref), **F32)


@pytest.mark.parametrize("b,h,kh,bs,mb,dh", [
    (2, 8, 2, 16, 8, 64), (1, 4, 4, 32, 4, 128), (3, 4, 1, 16, 6, 32)])
def test_paged_decode_plain_bf16_matches_oracle(b, h, kh, bs, mb, dh):
    q, kp, vp, tables, lengths = _paged_inputs(7, b, h, kh, bs, mb, dh)
    out = _port_paged(q, kp, vp, tables, lengths, "bfloat16")
    assert out.dtype == torch.bfloat16
    bf = jnp.bfloat16
    ref = flash_decode_paged_ref(
        jnp.asarray(q, bf).reshape(b, kh, h // kh, dh), jnp.asarray(kp, bf),
        jnp.asarray(vp, bf), jnp.asarray(tables),
        jnp.asarray(lengths)).reshape(b, h, dh)
    np.testing.assert_allclose(out.float().numpy(), _np(ref), **BF16)


def test_paged_decode_identity_table_matches_contiguous():
    """With the identity table the paged path equals one-token attention
    over the contiguous cache holding the same rows (the reference's
    ``decode_attention``, the XLA twin of its contiguous Pallas kernel)."""
    b, h, kh, bs, mb, dh = 2, 8, 2, 16, 8, 64
    rng = np.random.default_rng(11)
    kp = rng.standard_normal((b * mb, kh, bs, dh), np.float32)
    vp = rng.standard_normal((b * mb, kh, bs, dh), np.float32)
    q = rng.standard_normal((b, h, dh), np.float32)
    tables = np.arange(b * mb, dtype=np.int32).reshape(b, mb)
    lengths = np.asarray([mb * bs, mb * bs - 37], np.int32)
    paged = _port_paged(q, kp, vp, tables, lengths).numpy()
    kc = _pools_to_port(kp).reshape(b, mb * bs, kh, dh)   # (B, W, KH, dh)
    vc = _pools_to_port(vp).reshape(b, mb * bs, kh, dh)
    for i in range(b):
        row = jax_decode_attention(jnp.asarray(q[i:i + 1]),
                                   jnp.asarray(kc[i:i + 1]),
                                   jnp.asarray(vc[i:i + 1]),
                                   int(lengths[i]) - 1)
        np.testing.assert_allclose(paged[i], _np(row[0]), **F32)


def test_paged_decode_aliased_tables_share_exactly():
    """Two sequences whose tables alias the same leading blocks, with the
    same length and query, get bitwise-equal outputs (zero-copy sharing)."""
    b, h, kh, bs, mb, dh = 2, 4, 2, 16, 4, 64
    rng = np.random.default_rng(13)
    kp = rng.standard_normal((32, kh, bs, dh), np.float32)
    vp = rng.standard_normal((32, kh, bs, dh), np.float32)
    q1 = rng.standard_normal((1, h, dh), np.float32)
    q = np.concatenate([q1, q1])
    shared = [3, 9, 5]
    tables = np.asarray([shared + [11], shared + [20]], np.int32)
    lengths = np.asarray([3 * bs, 3 * bs], np.int32)      # tail block masked
    out = _port_paged(q, kp, vp, tables, lengths)
    assert torch.equal(out[0], out[1])


def test_paged_decode_zero_length_is_uniform_average():
    """``lengths == 0`` masks every row with the finite NEG_INF: the result
    is the uniform average over the table's rows, as the reference's."""
    q, kp, vp, tables, _ = _paged_inputs(3, 2, 4, 2, 16, 3, 32)
    lengths = np.asarray([0, 5], np.int32)
    out = _port_paged(q, kp, vp, tables, lengths).numpy()
    ref = flash_decode_paged_ref(
        jnp.asarray(q).reshape(2, 2, 2, 32), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lengths)).reshape(2, 4, 32)
    np.testing.assert_allclose(out, _np(ref), **F32)
    lane = _pools_to_port(vp)[tables[0]].reshape(-1, 2, 32)   # (W, KH, dh)
    np.testing.assert_allclose(out[0].reshape(2, 2, 32),
                               np.repeat(lane.mean(0)[:, None], 2, 1), **F32)


def _split_merge_model(q, k_pool, v_pool, tables, lengths):
    """The CUDA kernel's split-KV arithmetic, in f32 on the CPU: each split
    of ``split_geometry`` entries yields (max, sum, acc) in the log2 domain
    with the finite NEG_INF mask; splits past the walked entries are
    skipped; the splits are merged in split order. Port layouts:
    q (B, H, dh), pools (N, bs, KH, dh)."""
    b, h, dh = q.shape
    bs, kh = k_pool.shape[1], k_pool.shape[2]
    g = h // kh
    max_blocks = tables.shape[1]
    entries, _ = split_geometry(bs, max_blocks)
    q = q.float() * (dh ** -0.5 * np.log2(np.e))
    out = torch.empty(b, h, dh)
    for i in range(b):
        ln = int(lengths[i])
        walked = min(-(-ln // bs) if ln > 0 else max_blocks, max_blocks)
        parts = []
        for e0 in range(0, walked, entries):
            ents = tables[i, e0:min(e0 + entries, walked)].long()
            k = k_pool[ents].reshape(-1, kh, dh).float()    # (R, KH, dh)
            v = v_pool[ents].reshape(-1, kh, dh).float()
            s = torch.einsum("kgd,rkd->kgr", q[i].reshape(kh, g, dh), k)
            pos = e0 * bs + torch.arange(k.shape[0])
            s = torch.where(pos < ln, s, torch.tensor(NEG_INF))
            m = s.max(-1, keepdim=True).values
            p = torch.exp2(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("kgr,rkd->kgd", p, v)))
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        total = torch.zeros(kh, g, 1)
        acc = torch.zeros(kh, g, dh)
        for m, l, a in parts:                      # fixed split order
            w = torch.exp2(m - mx)
            total = total + w * l
            acc = acc + w * a
        out[i] = (acc / total.clamp_min(1e-30)).reshape(h, dh)
    return out


def test_paged_split_geometry_depends_on_block_size_alone():
    assert split_geometry(16, 32) == (4, 8)
    assert split_geometry(16, 10) == (4, 3)        # last split: 2 entries
    assert split_geometry(16, 1) == (4, 1)
    assert split_geometry(128, 4) == (1, 4)        # blocks over 64 rows
    assert split_geometry(1, 100) == (64, 2)


@pytest.mark.parametrize("bs,mb", [(16, 32), (16, 10), (8, 19)])
def test_paged_split_merge_model_matches_plain_and_pallas(bs, mb):
    """The split-and-merge arithmetic at the kernel's edge cases: empty
    (fully masked, every split walked), one row, a split boundary -1/0/+1,
    three splits, max_blocks not a multiple of the split, the full table."""
    b, h, kh, dh = 8, 6, 2, 32
    split = split_geometry(bs, mb)[0] * bs
    q, kp, vp, tables, _ = _paged_inputs(17, b, h, kh, bs, mb, dh,
                                         n_blocks=mb + 5)
    lengths = np.asarray([0, 1, split - 1, split, split + 1, 3 * split - 3,
                          mb * bs - 1, mb * bs], np.int32)
    model = _split_merge_model(_t(q), _t(_pools_to_port(kp)),
                               _t(_pools_to_port(vp)),
                               torch.from_numpy(tables), lengths)
    plain = _port_paged(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(model.numpy(), plain.numpy(), **F32)
    pallas = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), interpret=True)
    np.testing.assert_allclose(model.numpy(), _np(pallas), **F32)
    lane = _pools_to_port(vp)[tables[0]].reshape(-1, kh, dh)  # length 0
    np.testing.assert_allclose(
        model[0].reshape(kh, h // kh, dh).numpy(),
        np.repeat(lane.mean(0)[:, None], h // kh, 1), **F32)


def test_paged_split_merge_model_aliased_tables_are_bitwise_equal():
    """Tables aliasing the same 12 blocks (three 64-row splits at bs=16),
    with the same query and length: the partition depends only on logical
    position, so the merged outputs are bitwise equal."""
    q, kp, vp, tables, _ = _paged_inputs(19, 2, 4, 2, 16, 14, 32,
                                         n_blocks=40)
    q[1] = q[0]
    tables[1, :12] = tables[0, :12]
    lengths = np.asarray([12 * 16 - 5] * 2, np.int32)
    out = _split_merge_model(_t(q), _t(_pools_to_port(kp)),
                             _t(_pools_to_port(vp)), torch.from_numpy(tables),
                             lengths)
    assert torch.equal(out[0], out[1])


# ----------------------------------------------------------------- prefill
@pytest.mark.parametrize("b,h,kh,sq,skv,dh", [
    (2, 4, 2, 128, 128, 64),
    (1, 8, 2, 256, 256, 128),
    (2, 4, 4, 96, 96, 64),          # ragged
    (1, 4, 1, 64, 64, 32),          # MQA
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_plain_matches_pallas(b, h, kh, sq, skv, dh, dtype):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, h, sq, dh), np.float32)
    k = rng.standard_normal((b, kh, skv, dh), np.float32)
    v = rng.standard_normal((b, kh, skv, dh), np.float32)
    jd = getattr(jnp, dtype)
    pallas = flash_pallas(jnp.asarray(q, jd), jnp.asarray(k, jd),
                          jnp.asarray(v, jd))
    out = flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          torch.zeros(b, dtype=torch.int32),
                          torch.full((b,), skv, dtype=torch.int32))
    np.testing.assert_allclose(out.float().numpy(), _np(pallas), **_tol(dtype))


def test_prefill_plain_sliding_window_matches_oracle():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 4, 256, 64), np.float32)
    k = rng.standard_normal((1, 2, 256, 64), np.float32)
    v = rng.standard_normal((1, 2, 256, 64), np.float32)
    ref = flash_prefill_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            window=64)
    out = flash_attention_plain(_t(q), _t(k), _t(v),
                                torch.zeros(1, dtype=torch.int32),
                                torch.full((1,), 256, dtype=torch.int32),
                                window=64)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_offsets_match_naive_attention_over_lane(dtype):
    """Offset mode: row b's C queries at ``q_start[b]..`` attend a W-long
    lane up to ``q_start[b]+C``, as the reference's ``forward_chunk`` does
    with ``attention`` over the lane with per-row ``pos_q``."""
    b, h, kh, c, w, dh = 3, 8, 2, 16, 80, 32
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, c, h, dh), np.float32)
    lane_k = rng.standard_normal((b, w, kh, dh), np.float32)
    lane_v = rng.standard_normal((b, w, kh, dh), np.float32)
    starts = np.asarray([0, 23, 64], np.int32)
    pos_q = starts[:, None] + np.arange(c, dtype=np.int32)[None]
    pos_kv = np.broadcast_to(np.arange(w, dtype=np.int32)[None], (b, w))
    jd = getattr(jnp, dtype)
    ref = jax_attention_naive(jnp.asarray(q, jd), jnp.asarray(lane_k, jd),
                              jnp.asarray(lane_v, jd), jnp.asarray(pos_q),
                              jnp.asarray(pos_kv), causal=True)
    out = flash_attention(_t(q, dtype).transpose(1, 2).contiguous(),
                          _t(lane_k, dtype).transpose(1, 2).contiguous(),
                          _t(lane_v, dtype).transpose(1, 2).contiguous(),
                          torch.from_numpy(starts),
                          torch.from_numpy(starts + c))
    np.testing.assert_allclose(out.transpose(1, 2).float().numpy(), _np(ref),
                               **_tol(dtype))


# ------------------------------------------------------- plain attention
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_attention_naive_matches_reference(causal, window):
    b, sq, skv, h, kh, dh = 2, 7, 12, 6, 2, 16
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, sq, h, dh), np.float32)
    k = rng.standard_normal((b, skv, kh, dh), np.float32)
    v = rng.standard_normal((b, skv, kh, dh), np.float32)
    pos_q = np.stack([np.arange(5, 5 + sq), np.arange(2, 2 + sq)]).astype(
        np.int32)
    pos_kv = np.tile(np.arange(skv, dtype=np.int32), (b, 1))
    pos_kv[1, -3:] = -1                         # unwritten / PAD slots
    ref = jax_attention_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos_q), jnp.asarray(pos_kv),
                              causal=causal, window=window)
    out = attention_naive(_t(q), _t(k), _t(v), torch.from_numpy(pos_q),
                          torch.from_numpy(pos_kv), causal=causal,
                          window=window)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)


def test_write_paged_then_gather_lane_round_trips():
    """Rows written through a shuffled table come back, in position order,
    from the gathered lane; a decode past W wraps onto the row's own oldest
    block."""
    bs, kh, dh, mb = 4, 2, 3, 3
    pool = torch.zeros(10, bs, kh, dh)
    tables = torch.tensor([[7, 2, 5], [0, 9, 1]], dtype=torch.int32)
    new = torch.randn(2, mb * bs, kh, dh)
    positions = torch.arange(mb * bs)[None].expand(2, -1)
    write_paged(pool, tables, positions, new)
    lane = gather_lane(pool, tables)                      # (B, KH, W, dh)
    assert torch.equal(lane.transpose(1, 2), new)
    row = torch.randn(2, 1, kh, dh)
    write_paged(pool, tables, torch.tensor([[mb * bs + 1], [1]]), row)
    assert torch.equal(pool[7, 1], row[0, 0]) and torch.equal(pool[0, 1],
                                                              row[1, 0])


# ------------------------------------------------------------ ring decode
def _ring_rows(pos, b):
    """Per-row positions around the case's ``pos``: the case itself and
    rows further back (still >= 0)."""
    return np.asarray([max(pos - 91 * i, 0) for i in range(b)], np.int32)


@pytest.mark.parametrize("b,h,kh,w,dh,pos,win", [
    (2, 8, 2, 512, 64, 300, None),
    (1, 4, 4, 1024, 128, 800, None),
    (2, 4, 2, 256, 64, 700, 128),    # ring buffer wrapped
    (1, 8, 8, 300, 64, 150, None),   # ragged W
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_decode_plain_matches_pallas(b, h, kh, w, dh, pos, win, dtype):
    """The ring decode wrapper's plain version over heads-first lanes, with
    per-row ``pos`` and shuffled slots, against the Pallas ``flash_decode``
    (interpret mode) run one row at a time (it takes a scalar ``pos``)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, h, dh), np.float32)
    kc = rng.standard_normal((b, w, kh, dh), np.float32)   # reference layout
    vc = rng.standard_normal((b, w, kh, dh), np.float32)
    rows = _ring_rows(pos, b)
    jd = getattr(jnp, dtype)
    ref = np.concatenate([_np(decode_attention_pallas(
        jnp.asarray(q[i:i + 1], jd), jnp.asarray(kc[i:i + 1], jd),
        jnp.asarray(vc[i:i + 1], jd), int(rows[i]), window=win,
        interpret=True)) for i in range(b)])
    slots = np.arange(b, dtype=np.int32)[::-1].copy() + 1    # lanes 1..b
    lanes_k = np.zeros((b + 1, kh, w, dh), np.float32)
    lanes_v = np.zeros((b + 1, kh, w, dh), np.float32)
    lanes_k[slots] = kc.transpose(0, 2, 1, 3)
    lanes_v[slots] = vc.transpose(0, 2, 1, 3)
    out = ring_decode_attention(_t(q, dtype), _t(lanes_k, dtype),
                                _t(lanes_v, dtype), torch.from_numpy(slots),
                                torch.from_numpy(rows), window=win)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), ref, **_tol(dtype))


def _ring_split_merge_model(q, k_lanes, v_lanes, slots, pos, window):
    """The ring CUDA kernel's split-KV arithmetic, in f32 on the CPU: lane
    rows walked (``min(pos + 1, W)``) in runs of ``ring_split_geometry``
    rows; a row lies ``back = r - j`` (j <= r) or ``r - j + W`` positions
    before pos, r = pos % W, and with a window counts when back < window
    (else the finite NEG_INF); a split with no row in the window is skipped
    (its merge weight would be exactly 0); each split yields (max, sum, acc)
    in the log2 domain, merged in split order. Port layouts: q (B, H, dh),
    lanes (S, KH, W, dh)."""
    b, h, dh = q.shape
    kh, w = k_lanes.shape[1], k_lanes.shape[2]
    g = h // kh
    rows_per_split, _ = ring_split_geometry(w)
    qs = q.float() * (dh ** -0.5 * np.log2(np.e))
    out = torch.empty(b, h, dh)
    for i in range(b):
        p = int(pos[i])
        walked, r = min(p + 1, w), p % w
        lk = k_lanes[int(slots[i])].float()             # (KH, W, dh)
        lv = v_lanes[int(slots[i])].float()
        parts = []
        for j0 in range(0, walked, rows_per_split):
            j = torch.arange(j0, min(j0 + rows_per_split, walked))
            back = torch.where(j <= r, r - j, r - j + w)
            valid = (back < window if window is not None
                     else torch.ones_like(j, dtype=torch.bool))
            if not bool(valid.any()):
                continue
            s = torch.einsum("kgd,krd->kgr", qs[i].reshape(kh, g, dh),
                             lk[:, j])
            s = torch.where(valid, s, torch.tensor(NEG_INF))
            m = s.max(-1, keepdim=True).values
            pr = torch.exp2(s - m)
            parts.append((m, pr.sum(-1, keepdim=True),
                          torch.einsum("kgr,krd->kgd", pr, lv[:, j])))
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        total = torch.zeros(kh, g, 1)
        acc = torch.zeros(kh, g, dh)
        for m, l, a in parts:                      # fixed split order
            wgt = torch.exp2(m - mx)
            total = total + wgt * l
            acc = acc + wgt * a
        out[i] = (acc / total.clamp_min(1e-30)).reshape(h, dh)
    return out


def test_ring_split_geometry_depends_on_width_alone():
    import inspect
    assert list(inspect.signature(ring_split_geometry).parameters) == [
        "width"]
    assert ring_split_geometry(1024) == (64, 16)
    assert ring_split_geometry(128) == (64, 2)
    assert ring_split_geometry(64) == (64, 1)
    assert ring_split_geometry(65) == (64, 2)
    assert ring_split_geometry(300) == (64, 5)
    assert ring_split_geometry(1) == (64, 1)


@pytest.mark.parametrize("w,win", [(256, None), (256, 100), (200, 70),
                                   (64, 40)])
def test_ring_split_merge_model_matches_plain_and_pallas(w, win):
    """The split-and-merge arithmetic at the split edges: pos 0, 1, 63, 64,
    65 (unwrapped), W-1, W, W+63 and 3W+64 (wrapped), with a window shorter
    than the lane and without one."""
    kh, g, dh = 2, 3, 32
    pos = np.asarray([0, 1, 63, 64, 65, w - 1, w, w + 63, 3 * w + 64],
                     np.int32)
    b = len(pos)
    rng = np.random.default_rng(31)
    q = rng.standard_normal((b, kh * g, dh), np.float32)
    kc = rng.standard_normal((b, w, kh, dh), np.float32)  # reference layout
    vc = rng.standard_normal((b, w, kh, dh), np.float32)
    slots = np.arange(b, dtype=np.int32)[::-1].copy()
    lanes_k = np.zeros((b, kh, w, dh), np.float32)
    lanes_v = np.zeros((b, kh, w, dh), np.float32)
    lanes_k[slots] = kc.transpose(0, 2, 1, 3)
    lanes_v[slots] = vc.transpose(0, 2, 1, 3)
    args = (_t(q), _t(lanes_k), _t(lanes_v), torch.from_numpy(slots),
            torch.from_numpy(pos))
    model = _ring_split_merge_model(*args, win)
    plain = ring_decode_attention(*args, window=win)
    np.testing.assert_allclose(model.numpy(), plain.numpy(), **F32)
    ref = np.concatenate([_np(decode_attention_pallas(
        jnp.asarray(q[i:i + 1]), jnp.asarray(kc[i:i + 1]),
        jnp.asarray(vc[i:i + 1]), int(pos[i]), window=win, interpret=True))
        for i in range(b)])
    np.testing.assert_allclose(model.numpy(), ref, **F32)


def test_ring_split_merge_model_same_slot_and_pos_are_bitwise_equal():
    """Two rows reading the same lane at the same pos with the same query
    (three splits, wrapped, under a window) get bitwise-equal outputs,
    whatever the other rows of the batch hold."""
    kh, g, dh, w = 2, 2, 32, 192
    rng = np.random.default_rng(37)
    q = rng.standard_normal((4, kh * g, dh), np.float32)
    q[2] = q[0]
    lanes = rng.standard_normal((3, kh, w, dh), np.float32)
    slots = torch.tensor([1, 0, 1, 2], dtype=torch.int32)
    pos = torch.tensor([2 * w + 70, 5, 2 * w + 70, 900], dtype=torch.int32)
    out = _ring_split_merge_model(_t(q), _t(lanes), _t(lanes), slots, pos,
                                  150)
    assert torch.equal(out[0], out[2])


def test_update_and_prefill_cache_place_rows_at_ring_slots():
    """Decode writes land at ``pos % W`` as the reference's
    ``update_cache``; a prompt longer than the lane keeps its last W rows
    at their ring slots."""
    s, kh, w, dh = 3, 2, 8, 4
    rng = np.random.default_rng(6)
    lanes = torch.zeros(s, kh, w, dh)
    new = rng.standard_normal((2, kh, dh), np.float32)
    slots, pos = torch.tensor([2, 0]), torch.tensor([13, 5])
    update_cache(lanes, slots, torch.from_numpy(new), pos)
    for row, (slot, p) in enumerate(zip(slots.tolist(), pos.tolist())):
        ref = jax_update_cache(jnp.zeros((1, w, kh, dh)),
                               jnp.asarray(new[row:row + 1]), p)
        np.testing.assert_array_equal(lanes[slot].transpose(0, 1).numpy(),
                                      _np(ref[0]))
    prompt = torch.from_numpy(rng.standard_normal((1, 11, kh, dh),
                                                  np.float32))
    prefill_cache(lanes, torch.tensor([1]), prompt)
    for p in range(3, 11):
        assert torch.equal(lanes[1, :, p % w], prompt[0, p])


# ------------------------------------------------- chunked linear attention
def _linear_inputs(mode, b, h, t, dk, dv, seed=3):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, t, dk), np.float32) for _ in range(2))
    v = rng.standard_normal((b, h, t, dv), np.float32)
    lw_dim = dk if mode == "rwkv" else 1
    lw = -1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, t, lw_dim),
                                                   np.float32)))
    u = (rng.standard_normal((h, dk), np.float32) * 0.1 if mode == "rwkv"
         else None)
    return q, k, v, lw.astype(np.float32), u


LIN = dict(atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("mode", ["rwkv", "ssd"])
@pytest.mark.parametrize("b,h,t,dk,dv", [
    (2, 4, 128, 64, 64),
    (1, 2, 200, 32, 64),             # ragged T -> padding
    (1, 1, 64, 16, 16),
])
def test_linear_attention_plain_matches_pallas_and_recurrence(mode, b, h, t,
                                                              dk, dv):
    """Output against the Pallas kernel (interpret) and the token-by-token
    recurrence; the final state against the reference's chunked scan and
    against the port's one-token steps."""
    q, k, v, lw, u = _linear_inputs(mode, b, h, t, dk, dv)
    out, state = linear_attention(_t(q), _t(k), _t(v), _t(lw),
                                  None if u is None else _t(u), mode=mode)
    ju = jnp.asarray(u) if u is not None else jnp.ones((h, dk))
    pallas = linear_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lw),
                                     None if u is None else ju, mode=mode)
    rec = rwkv6_recurrent_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lw), ju, mode=mode)
    np.testing.assert_allclose(out.numpy(), _np(pallas), **LIN)
    np.testing.assert_allclose(out.numpy(), _np(rec), **LIN)
    tp = -(-t // 64) * 64                # the reference scans whole chunks
    pad = ((0, 0), (0, 0), (0, tp - t), (0, 0))
    _, jstate = jax_chunked_linear_attention(
        *(jnp.asarray(np.pad(x, pad)) for x in (q, k, v, lw)),
        bonus=None if u is None else ju, mode=mode, chunk_size=64)
    np.testing.assert_allclose(state.numpy(), _np(jstate), **LIN)
    st = torch.zeros(b, h, dk, dv)
    for i in range(t):
        _, st = linear_attention_step(
            st, _t(q[:, :, i]), _t(k[:, :, i]), _t(v[:, :, i]),
            _t(lw[:, :, i]), bonus=None if u is None else _t(u), mode=mode)
    np.testing.assert_allclose(state.numpy(), st.numpy(), **LIN)


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _mm_3xtf32(a, b, d=None):
    """d + a @ b as the kernel's mma.sync 3xTF32: over k-steps of 8 in
    order, each operand split into hi = tf32(x) and lo = tf32(x - hi), and
    d += a_lo b_hi, then a_hi b_lo, then a_hi b_hi."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1]) if d is None else d
    for k0 in range(0, a.shape[-1], 8):
        a8, b8 = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        ah, bh = _tf32(a8), _tf32(b8)
        al, bl = _tf32(a8 - ah), _tf32(b8 - bh)
        out = out + al @ bh
        out = out + ah @ bl
        out = out + ah @ bh
    return out


def _warp_scan_model(x):
    """Inclusive sum over dim -2 (the chunk's rows) in the kernel's order:
    rounds of 32 rows, each a Hillis-Steele scan over the 32 lanes plus the
    carry of the rounds before."""
    outs, carry = [], torch.zeros_like(x[..., :1, :])
    for r0 in range(0, x.shape[-2], 32):
        y = x[..., r0:r0 + 32, :]
        for off in (1, 2, 4, 8, 16):
            y = torch.cat([y[..., :off, :], y[..., off:, :] + y[..., :-off, :]],
                          -2)
        y = carry + y
        carry = y[..., -1:, :]
        outs.append(y)
    return torch.cat(outs, -2)


def _chunk_kernel_model(q, k, v, lw, u, mode, chunk):
    """The chunked CUDA kernel's arithmetic in f32 on the CPU: the warp
    scan of the log-decay, the decayed operands, the scores masked strictly
    lower with the diagonal term on the diagonal, att V + Q_dec S into one
    accumulator, then S * exp(total) + K_tail^T V, every product in
    3xTF32. Returns (out, final state)."""
    b, h, t, dk = q.shape
    state = torch.zeros(b, h, dk, v.shape[-1])
    row = torch.arange(chunk)
    outs = []
    for c0 in range(0, t, chunk):
        qc, kc, vc, lc = (x[:, :, c0:c0 + chunk] for x in (q, k, v, lw))
        inc = _warp_scan_model(lc)
        tot = inc[:, :, -1:]
        if mode == "rwkv":
            qd = qc * torch.exp(inc - lc)
            dg = (qc * u[None, :, None] * kc).sum(-1)
        else:
            qd = qc * torch.exp(inc)
            dg = (qc * kc).sum(-1)
        kd, kt = kc * torch.exp(-inc), kc * torch.exp(tot - inc)
        att = _mm_3xtf32(qd, kd.transpose(-1, -2))
        att = torch.where(row[:, None] > row[None], att,
                          torch.zeros(()))
        att = att + torch.diag_embed(dg)
        o = _mm_3xtf32(att, vc)
        outs.append(_mm_3xtf32(qd, state, o))
        state = (state * torch.exp(tot).transpose(-1, -2)
                 + _mm_3xtf32(kt.transpose(-1, -2), vc))
    return torch.cat(outs, 2), state


@pytest.mark.parametrize("mode,dk,dv", [("ssd", 16, 16), ("rwkv", 32, 16)])
@pytest.mark.parametrize("edge", [False, True])
def test_3xtf32_chunk_model_matches_pallas_and_recurrence(mode, dk, dv,
                                                         edge):
    """The kernel's 3xTF32 chunk products hold the reference's 5e-4, also
    with every step's log-decay at the contract's edge (-MAX_LOG_DECAY,
    where exp(+-inc) spreads the decayed operands over e^+-64)."""
    b, h, t = 1, 2, 128
    q, k, v, lw, u = _linear_inputs(mode, b, h, t, dk, dv, seed=41)
    if edge:
        lw = np.full_like(lw, -MAX_LOG_DECAY)
    out, state = _chunk_kernel_model(
        _t(q), _t(k), _t(v), _t(lw), None if u is None else _t(u), mode, 64)
    ju = jnp.asarray(u) if u is not None else jnp.ones((h, dk))
    pallas = linear_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lw),
                                     None if u is None else ju, mode=mode)
    rec = rwkv6_recurrent_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lw), ju, mode=mode)
    np.testing.assert_allclose(out.numpy(), _np(pallas), **LIN)
    np.testing.assert_allclose(out.numpy(), _np(rec), **LIN)
    _, jstate = jax_chunked_linear_attention(
        *(jnp.asarray(x) for x in (q, k, v, lw)),
        bonus=None if u is None else ju, mode=mode, chunk_size=64)
    np.testing.assert_allclose(state.numpy(), _np(jstate), **LIN)


def test_tf32_rounding_model_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0e27, 0.0])
    np.testing.assert_array_equal(
        _tf32(x).numpy(),
        np.asarray([one + ulp, -(one + ulp), one, one + 2 * ulp,
                    _tf32(torch.tensor([3.0e27])).item(), 0.0], np.float32))
    assert (_tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()


def test_linear_attention_rejects_chunks_past_the_decay_contract():
    q, k, v, lw, _ = _linear_inputs("ssd", 1, 1, 128, 16, 16)
    with pytest.raises(ValueError, match="MAX_LOG_DECAY"):
        linear_attention(_t(q), _t(k), _t(v), _t(lw), mode="ssd", chunk=128)


def test_cpu_wrappers_take_the_plain_path_and_count_no_launch():
    wrappers = (paged_decode_attention, flash_attention,
                ring_decode_attention, linear_attention, slot_positions)
    before = [w.launches for w in wrappers]
    q, kp, vp, tables, lengths = _paged_inputs(1, 1, 2, 1, 16, 2, 32)
    a = _port_paged(q, kp, vp, tables, lengths)
    bq = torch.from_numpy(q)
    b = paged_decode_attention_plain(
        bq, _t(_pools_to_port(kp)), _t(_pools_to_port(vp)),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    assert torch.equal(a, b)
    lanes = torch.randn(3, 1, 8, 32)
    args = (bq, lanes, lanes, torch.tensor([2], dtype=torch.int32),
            torch.tensor([11], dtype=torch.int32))
    assert torch.equal(ring_decode_attention(*args),
                       ring_decode_attention_plain(*args))
    linear_attention(torch.ones(1, 1, 8, 4), torch.ones(1, 1, 8, 4),
                     torch.ones(1, 1, 8, 4), -torch.ones(1, 1, 8, 1) / 2,
                     mode="ssd", chunk=32)
    experts = torch.tensor([[[3, 1], [1, 0], [3, 2]]])
    assert torch.equal(slot_positions(experts, 4),
                       slot_positions_plain(experts, 4))
    assert [w.launches for w in wrappers] == before


def _places_by_loop(gate_idx: np.ndarray, num_experts: int) -> np.ndarray:
    """Each slot's place within its expert, counted one slot at a time:
    every token's first choice in token order, then every second, ..."""
    g, t, k = gate_idx.shape
    places = np.zeros((g, k * t), np.int64)
    for group in range(g):
        seen = [0] * num_experts
        for j in range(k):
            for token in range(t):
                e = gate_idx[group, token, j]
                places[group, j * t + token] = seen[e]
                seen[e] += 1
    return places


SLOT_CASES = [(e, k, t, g, False) for e in (4, 64, 384) for k in (2, 6, 8)
              if k <= e for t in (1, 7, 64, 512) for g in (1, 3)]


@pytest.mark.parametrize("e,k,t,g,one_expert",
                         SLOT_CASES + [(64, 8, 512, 3, True),
                                       (4, 2, 7, 1, True)])
def test_slot_positions_plain_counts_each_expert_in_slot_major_order(
        e, k, t, g, one_expert):
    """The one-hot ``cumsum`` gives each slot the number of earlier slots
    of its group (slot-major) routed to its expert, whether the router's
    k distinct choices a token (read from a view of its sorted experts, as
    the router leaves them) or every slot on expert 0; the wrapper on the
    CPU gives the same."""
    rng = np.random.default_rng(e * 1000 + k * 100 + t + g)
    order = np.argsort(rng.random((g, t, e)), -1)
    if one_expert:
        order[:] = 0
    gate_idx = torch.from_numpy(order)[..., :k]
    want = _places_by_loop(order[..., :k], e)
    assert np.array_equal(slot_positions_plain(gate_idx, e).numpy(), want)
    assert torch.equal(slot_positions(gate_idx, e),
                       slot_positions_plain(gate_idx, e))


# The kernels have no backward: a wrapper given an operand that requires
# grad under grad mode raises, on the CPU too (where its plain version would
# otherwise differentiate, and the card would silently drop the gradient).
def _grad_operand(shape):
    return torch.randn(*shape).requires_grad_(True)


def _refuses_grad(call):
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():          # the same call without grad mode runs
        call()


def test_paged_decode_refuses_grad():
    pool = torch.randn(3, 16, 1, 32)
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    lengths = torch.tensor([20], dtype=torch.int32)
    _refuses_grad(lambda: paged_decode_attention(
        _grad_operand((1, 2, 32)), pool, pool, tables, lengths))


def test_prefill_refuses_grad():
    kv = torch.randn(1, 1, 8, 32)
    zero = torch.zeros(1, dtype=torch.int32)
    full = torch.full((1,), 8, dtype=torch.int32)
    _refuses_grad(lambda: flash_attention(
        torch.randn(1, 2, 8, 32), _grad_operand((1, 1, 8, 32)), kv, zero,
        full))


def test_ring_decode_refuses_grad():
    lanes = torch.randn(2, 1, 8, 32)
    _refuses_grad(lambda: ring_decode_attention(
        torch.randn(1, 2, 32), lanes, _grad_operand((2, 1, 8, 32)),
        torch.tensor([1], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32)))


def test_linear_attention_refuses_grad():
    x = torch.ones(1, 1, 8, 4)
    _refuses_grad(lambda: linear_attention(
        x, x, x, -_grad_operand((1, 1, 8, 1)).abs(), mode="ssd", chunk=32))
