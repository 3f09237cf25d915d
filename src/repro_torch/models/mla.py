"""Multi-head latent attention (MLA), DeepSeek-V2/V3's attention
[arXiv:2405.04434 §2.1]: a latent KV of ``kv_lora_rank`` columns beside one
rotary key shared by every head, the query straight from the input (as
Moonlight-16B-A3B publishes it) or through a low-rank path (DeepSeek-V3,
Kimi K2).

Per layer ``p`` holds ``wq`` (d, H*(dn+dr)), or with a ``q_lora_rank`` of
``qr`` ``wq_a`` (d, qr), ``q_norm`` (its RMSNorm scale, qr) and ``wq_b``
(qr, H*(dn+dr)); then ``wkv_a`` (d, r+dr), ``kv_norm`` (the latent's
RMSNorm scale, r), ``wkv_b`` (r, H*(dn+dv)) and ``wo`` (H*dv, d), with
``dn, dr, dv, r`` the config's ``qk_nope_head_dim``, ``qk_rope_head_dim``,
``v_head_dim`` and ``kv_lora_rank``::

    q = x wq, or rmsnorm(x wq_a) wq_b   per head [q_nope (dn) | q_pe (dr)]
    [c | k_pe] = x wkv_a;  c = rmsnorm(c)
    q_pe, k_pe rotated (rotate-half RoPE at the token's position; YaRN's
        frequencies and cos/sin scale where the config scales its rope)
    [k_nope | v] = c wkv_b        per head
    attention of [q_nope | q_pe] over [k_nope | k_pe], scale 1/sqrt(dn+dr)
        (times YaRN's mscale^2), weighting v; out = attention wo

The decode cache holds the latent row ``[c | k_pe]`` (r + dr columns) a
token a layer, one pool ``(L, N+1, bs, r+dr)`` in place of K and V pools.

* Prefill (:func:`seq_attention`, :func:`chunk_attention`) attends in the
  published, non-absorbed form: a first chunk expands its own latent rows
  through ``wkv_b``; a continuation chunk gathers its row's latent lane from
  the pool and expands it (``mla.expand``). The prefill kernel takes QK rows
  of dn+dr columns and V rows of dv.
* Decode (:func:`decode_attention`) absorbs: each head's key up-projection
  ``W_UK`` folds into its query (``mla.absorb``: q_nope W_UK^T, r columns,
  beside q_pe), so the latent decode kernel scores every head against the
  cached rows themselves and weights their first r columns (``mla.latent``,
  with the row's write); the value up-projection ``W_UV`` then unfolds the
  result (``mla.unabsorb``). ``q_nope . k_nope = (q_nope W_UK^T) . c``, so
  this is the same function in another order of products.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.configs.latent import norm_eps, yarn_of
from repro_torch.kernels.flash_decode.ops import latent_decode_attention
from repro_torch.models.attention import prefill_attention, write_paged
from repro_torch.models.common import (apply_norm, apply_rope, dense_init,
                                       rope_freqs)


def init_attn(gen, cfg, dtype: torch.dtype, n: int) -> dict:
    """``n`` layers' stacked MLA weights, fan-in scaled, the latent norm's
    scale ones."""
    d, h = cfg.d_model, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dqk, dv = cfg.qk_head_dim, cfg.v_head_dim

    def dense(*shape):
        return dense_init(gen, (n,) + shape, in_axis_size=shape[0],
                          dtype=dtype)

    def ones(width):
        return {"scale": torch.ones(n, width, dtype=dtype, device=gen.device)}
    qr = cfg.q_lora_rank
    q = ({"wq_a": dense(d, qr), "q_norm": ones(qr), "wq_b": dense(qr, h * dqk)}
         if qr else {"wq": dense(d, h * dqk)})
    return {**q, "wkv_a": dense(d, r + dr), "kv_norm": ones(r),
            "wkv_b": dense(r, h * (cfg.qk_nope_head_dim + dv)),
            "wo": dense(h * dv, d)}


def param_count(cfg) -> int:
    """Parameters of one layer's MLA weights."""
    d, h, r, qr = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank, \
        cfg.q_lora_rank
    q = d * qr + qr + qr * h * cfg.qk_head_dim if qr else \
        d * h * cfg.qk_head_dim
    return (q + d * (r + cfg.qk_rope_head_dim) + r
            + r * h * (cfg.qk_nope_head_dim + cfg.v_head_dim)
            + h * cfg.v_head_dim * d)


_YARN_FREQS: dict = {}


def _yarn_freqs(cfg, y, device: torch.device) -> torch.Tensor:
    """YaRN's rope frequencies (dr/2,) f32: each pair's ``theta^(-2i/dr)``
    times ``1 - ramp_i``, plus that over ``factor`` times ``ramp_i``,
    ``ramp_i = clamp((i - low) / (high - low), 0, 1)``. Kept per device
    (a step's graphs replay them), but not from a capture, whose tensors
    hold nothing until a replay."""
    dr = cfg.qk_rope_head_dim
    key = (dr, cfg.rope_theta, y, device)
    if key in _YARN_FREQS:
        return _YARN_FREQS[key]
    base = rope_freqs(dr, cfg.rope_theta, device)
    ramp = ((torch.arange(dr // 2, dtype=torch.float32, device=device)
             - y.low) / (y.high - y.low)).clamp(0, 1)
    freqs = base / y.factor * ramp + base * (1 - ramp)
    if not (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        _YARN_FREQS[key] = freqs
    return freqs


def _rope(x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """The rope columns ``x`` (B, S, h, dr) rotated at ``positions``: plain
    rope, or YaRN's where the config scales its rope."""
    y = yarn_of(cfg)
    if y is None:
        return apply_rope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta,
                      _yarn_freqs(cfg, y, x.device), y.rope_scale)


def project(p: dict, xn: torch.Tensor, cfg, positions: torch.Tensor):
    """Queries (B, S, H, dn+dr) and latent rows (B, S, r+dr) of the normed
    inputs ``xn`` (B, S, d) at ``positions`` (B, S), their rope parts
    rotated."""
    b, s, _ = xn.shape
    dn, r, eps = cfg.qk_nope_head_dim, cfg.kv_lora_rank, norm_eps(cfg)
    if cfg.q_lora_rank:
        with trace.span("mla.q_lora"):
            q = apply_norm(p["q_norm"], xn @ p["wq_a"], "rmsnorm",
                           eps) @ p["wq_b"]
    else:
        q = xn @ p["wq"]
    q = q.view(b, s, cfg.num_heads, cfg.qk_head_dim)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], positions, cfg)], -1)
    kv = xn @ p["wkv_a"]
    c = apply_norm(p["kv_norm"], kv[..., :r], "rmsnorm", eps)
    k_pe = _rope(kv[..., None, r:], positions, cfg)
    return q, torch.cat([c, k_pe[:, :, 0]], -1)


def expand(p: dict, latent: torch.Tensor, cfg):
    """Latent rows (B, S, r+dr) -> heads-first keys (B, H, S, dn+dr) and
    values (B, H, S, dv), the prefill kernel's layout."""
    b, s, _ = latent.shape
    h, dn, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    kv = (latent[..., :r] @ p["wkv_b"]).view(b, s, h, dn + cfg.v_head_dim)
    k_pe = latent[:, :, None, r:].expand(b, s, h, cfg.qk_rope_head_dim)
    k = torch.cat([kv[..., :dn], k_pe], -1)
    return (k.transpose(1, 2).contiguous(),
            kv[..., dn:].transpose(1, 2).contiguous())


def _heads_of(p: dict, cfg) -> torch.Tensor:
    """``wkv_b`` as (r, H, dn+dv): each head's W_UK then W_UV."""
    return p["wkv_b"].view(cfg.kv_lora_rank, cfg.num_heads,
                           cfg.qk_nope_head_dim + cfg.v_head_dim)


def absorb(p: dict, q: torch.Tensor, cfg) -> torch.Tensor:
    """Queries (B, H, dn+dr) -> (B, H, r+dr): each head's nope part through
    its W_UK^T, its rope part as it is."""
    dn = cfg.qk_nope_head_dim
    w_uk = _heads_of(p, cfg)[..., :dn]                       # (r, H, dn)
    q_lat = torch.bmm(q[..., :dn].transpose(0, 1),
                      w_uk.permute(1, 2, 0)).transpose(0, 1)  # (B, H, r)
    return torch.cat([q_lat, q[..., dn:]], -1)


def unabsorb(p: dict, out: torch.Tensor, cfg) -> torch.Tensor:
    """Attention-weighted latents (B, H, r) -> values (B, H, dv) through
    each head's W_UV."""
    w_uv = _heads_of(p, cfg)[..., cfg.qk_nope_head_dim:]     # (r, H, dv)
    return torch.bmm(out.transpose(0, 1),
                     w_uv.transpose(0, 1)).transpose(0, 1)


def scale(cfg) -> float:
    """The softmax scale: ``1/sqrt(dn+dr)``, times YaRN's mscale^2 where
    the config scales its rope."""
    y = yarn_of(cfg)
    base = cfg.qk_head_dim ** -0.5
    return base if y is None else base * y.softmax_scale


def seq_attention(p: dict, xn: torch.Tensor, cfg, positions: torch.Tensor,
                  pool=None, tables=None, n: int = 0) -> torch.Tensor:
    """A first chunk (B, S, d) from position 0 over its own rows -> (B, S,
    H, dv). With ``pool`` (N+1, bs, r+dr) the first ``n`` rows' latent rows
    land in it through ``tables``."""
    b, s, _ = xn.shape
    q, latent = project(p, xn, cfg, positions)
    if pool is not None:
        with trace.span("mla.latent"):
            write_paged(pool, tables, positions[:n], latent[:n])
    k, v = expand(p, latent, cfg)
    return prefill_attention(
        q, k, v, torch.zeros(b, dtype=torch.int32, device=xn.device),
        torch.full((b,), s, dtype=torch.int32, device=xn.device),
        scale=scale(cfg))


def chunk_attention(p: dict, xn: torch.Tensor, cfg, positions: torch.Tensor,
                    pool: torch.Tensor, tables: torch.Tensor,
                    pos0: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """A continuation chunk (B, C, d) at ``positions`` (B, C): its latent
    rows written into ``pool`` first, then its queries over the row's lane
    of ``tables``' entries, expanded, keys ``[0, kv_len)`` -> (B, C, H,
    dv)."""
    b = xn.shape[0]
    q, latent = project(p, xn, cfg, positions)
    with trace.span("mla.latent"):
        write_paged(pool, tables, positions, latent)
    with trace.span("mla.expand"):
        lane = pool[tables.long()].reshape(b, -1, pool.shape[-1])
        k, v = expand(p, lane, cfg)
    return prefill_attention(q, k, v, pos0, kv_len, scale=scale(cfg))


def decode_attention(p: dict, xn: torch.Tensor, cfg,
                     positions: torch.Tensor, pool: torch.Tensor,
                     tables: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One token per row (B, 1, d) at ``positions`` (B, 1), absorbed: its
    latent row written into ``pool``, then the latent decode kernel over
    ``lengths`` rows -> (B, 1, H, dv)."""
    q, latent = project(p, xn, cfg, positions)
    with trace.span("mla.absorb"):
        q = absorb(p, q[:, 0], cfg)
    with trace.span("mla.latent"):
        write_paged(pool, tables, positions, latent)
        out = latent_decode_attention(q, pool, tables, lengths,
                                      cfg.kv_lora_rank, scale(cfg))
    with trace.span("mla.unabsorb"):
        return unabsorb(p, out, cfg)[:, None]
