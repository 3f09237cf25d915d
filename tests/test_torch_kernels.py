"""The port's attention kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions, which are
held here against the Pallas kernels in interpret mode and their jnp oracles
(atol = rtol = 2e-5 in f32, 2e-2 in bf16, the tolerances of
``tests/test_kernels.py``). The CUDA kernels themselves are held against
the plain versions on the card, by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.ops import paged_decode_attention_pallas
from repro.kernels.flash_decode.ref import flash_decode_paged_ref
from repro.kernels.flash_prefill.ops import flash_attention as flash_pallas
from repro.kernels.flash_prefill.ref import flash_prefill_ref
from repro.models.attention import attention_naive as jax_attention_naive
from repro.models.attention import decode_attention as jax_decode_attention
from repro_torch.kernels.flash_decode.ops import (paged_decode_attention,
                                                  paged_decode_attention_plain)
from repro_torch.kernels.flash_prefill.ops import (flash_attention,
                                                   flash_attention_plain)
from repro_torch.models.attention import (attention_naive, gather_lane,
                                          write_paged)

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


def test_cpu_wrappers_take_the_plain_path_and_count_no_launch():
    before = (paged_decode_attention.launches, flash_attention.launches)
    q, kp, vp, tables, lengths = _paged_inputs(1, 1, 2, 1, 16, 2, 32)
    a = _port_paged(q, kp, vp, tables, lengths)
    bq = torch.from_numpy(q)
    b = paged_decode_attention_plain(
        bq, _t(_pools_to_port(kp)), _t(_pools_to_port(vp)),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    assert torch.equal(a, b)
    assert (paged_decode_attention.launches, flash_attention.launches) \
        == before
