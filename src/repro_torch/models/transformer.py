"""Decoder-only transformer, dense family: parameters, prefill, chunked
continuation and decode over a paged KV cache.

Port of ``repro/models/transformer.py`` for the DENSE family. Parameters
keep the reference's pytree layout as nested dicts of tensors, with every
layer leaf stacked on a leading ``num_layers`` axis, so bridged JAX
parameters drop in unchanged; the layer loop is a Python loop where JAX used
``lax.scan``.

The decode cache is paged (the reference's contiguous lanes are the special
case of an identity table)::

    {"k", "v": (L, N+1, bs, KH, dh) pools, block N a null block,
     "tables": (B, max_blocks) int32 block table per sequence,
     "pos": (B,) int32 tokens resident per sequence}

:func:`init_cache` builds one with identity tables; the serving engine
passes its global pool with the dispatched requests' tables. The lane width
is ``W = max_blocks * bs``. Every function that takes a cache writes the new
K/V rows into its pools **in place** (the pools are the serving engine's
memory, too large to copy per step) and returns a dict with the advanced
``pos``. Per-row ``pos`` lets one call serve sequences at different offsets
(the reference ran one row per ``vmap`` lane with a scalar ``pos``).

Attention runs on the port's two kernels: prefill attention for
:func:`forward_seq` (``q_start = 0`` over the prompt's own K/V) and
:func:`forward_chunk` (per-row offsets over lanes gathered from the pool),
paged decode attention for :func:`decode_step` (no gather).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_decode.ops import paged_decode_attention
from repro_torch.models.attention import (gather_lane, prefill_attention,
                                          write_paged)
from repro_torch.models.common import (activate, apply_norm, apply_rope,
                                       dense_init, embed_init, gated,
                                       init_norm, positions_for)

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

# The ROADMAP item (section A) that ports each family this module rejects.
_ROADMAP_ITEM = {"moe": "A9 (MoE and VLM)", "vlm": "A9 (MoE and VLM)",
                 "ssm": "A10 (recurrent families)",
                 "hybrid": "A10 (recurrent families)",
                 "audio": "A11 (encoder-decoder)"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.family != DENSE or cfg.is_encdec:
        item = _ROADMAP_ITEM.get(cfg.family, "A11")
        raise NotImplementedError(
            f"the port runs the dense family only; {cfg.family} waits for "
            f"ROADMAP item {item}")
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window lanes need the ring decode kernel: ROADMAP items "
            "A5 and B3 (flash_decode)")
    if cfg.pos_emb != "rope":
        raise NotImplementedError(
            f"pos_emb={cfg.pos_emb!r}: the port's dense family uses rope; "
            f"learned positions wait for ROADMAP item A11")


# ===========================================================================
# Parameter initialization
# ===========================================================================
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = "cuda",
                param_dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters in the reference's layout, drawn on ``device`` from
    a ``torch.Generator`` seeded with ``seed`` (the reference's
    distributions, not its bits: parity tests bridge JAX parameters)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = param_dtype or getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(shape, fan_in=None):
        return dense_init(gen, (L,) + shape, in_axis_size=fan_in or shape[0],
                          dtype=dtype)

    def stacked_norm():
        return {k: v.expand(L, -1).contiguous() for k, v in
                init_norm(d, cfg.norm, dtype, dev).items()}

    def zeros(n):
        return torch.zeros(L, n, dtype=dtype, device=dev)

    attn = {"wq": dense((d, h * dh)), "wk": dense((d, kh * dh)),
            "wv": dense((d, kh * dh)), "wo": dense((h * dh, d))}
    mlp = {"w_up": dense((d, f)), "w_down": dense((f, d))}
    if gated(cfg.activation):
        mlp["w_gate"] = dense((d, f))
    if cfg.use_bias:
        attn.update(bq=zeros(h * dh), bk=zeros(kh * dh), bv=zeros(kh * dh),
                    bo=zeros(d))
        mlp.update(b_up=zeros(f), b_down=zeros(d))
    params: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, d), dtype),
        "final_norm": init_norm(d, cfg.norm, dtype, dev),
        "layers": {"ln1": stacked_norm(), "ln2": stacked_norm(),
                   "attn": attn, "mlp": mlp},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=dtype)
    return params


def layer_params(params: Params, layer: int) -> Params:
    """Layer ``layer``'s slice of the stacked ``params["layers"]`` tree."""
    def pick(tree):
        return ({k: pick(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[layer])
    return pick(params["layers"])


# ===========================================================================
# Cache construction
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               block_size: int = 16, dtype: Optional[torch.dtype] = None,
               device: DeviceLike = "cuda") -> Cache:
    """An empty paged cache with identity tables: row b owns blocks
    ``b*mb .. b*mb + mb - 1`` of an ``N = batch*mb`` block pool (plus the
    null block), ``mb = max_len / block_size``."""
    check_supported(cfg)
    if max_len % block_size:
        raise ValueError(f"max_len={max_len} must be a multiple of "
                         f"block_size={block_size}")
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    mb = max_len // block_size
    n = batch * mb
    shape = (cfg.num_layers, n + 1, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "tables": torch.arange(n, dtype=torch.int32,
                                   device=dev).reshape(batch, mb),
            "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}


# ===========================================================================
# Blocks
# ===========================================================================
def _linear(x: torch.Tensor, p: Params, w: str, b: str) -> torch.Tensor:
    y = x @ p[w]
    return y + p[b] if b in p else y


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return (_linear(x, p, "wq", "bq").reshape(b, s, h, dh),
            _linear(x, p, "wk", "bk").reshape(b, s, kh, dh),
            _linear(x, p, "wv", "bv").reshape(b, s, kh, dh))


def _rope_qk(q, k, cfg: ModelConfig, positions):
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = _linear(x, p, "w_up", "b_up")
    gate = x @ p["w_gate"] if "w_gate" in p else None
    return _linear(activate(up, gate, cfg.activation), p, "w_down", "b_down")


def _attn_out(lp: Params, x, out):
    b, s = out.shape[:2]
    return x + _linear(out.reshape(b, s, -1), lp["attn"], "wo", "bo")


def _ffn_residual(lp: Params, x, cfg: ModelConfig):
    return x + _mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg.norm), cfg)


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _final(params: Params, cfg: ModelConfig, x: torch.Tensor):
    return _unembed(params, cfg, apply_norm(params["final_norm"], x,
                                            cfg.norm))


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, KH, dh) -> contiguous (B, KH, S, dh), the kernels' layout."""
    return x.transpose(1, 2).contiguous()


_NO_AUX = {"load_balance_loss": 0.0, "router_z_loss": 0.0}


# ===========================================================================
# Top level
# ===========================================================================
def forward_seq(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                build_cache: bool = False, cache_len: int = 0,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache], dict]:
    """Full-sequence forward from position 0. tokens: (B, S) int.

    Returns ``(logits (B, S, V), cache-or-None, aux)``. With ``cache`` the
    prompt's K/V rows ``[0, S)`` are written into its pools through its
    tables and its ``pos`` becomes S (the serving engine's first-chunk
    prefill); ``build_cache=True`` does the same into a fresh
    ``init_cache(cfg, B, cache_len)``."""
    check_supported(cfg)
    b, s = tokens.shape
    x = params["embed"][tokens]
    dev = x.device
    if cache is None and build_cache:
        cache = init_cache(cfg, b, cache_len, dtype=x.dtype, device=dev)
    positions = positions_for(b, 0, s, dev)
    q_start = torch.zeros(b, dtype=torch.int32, device=dev)
    kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    for layer in range(cfg.num_layers):
        lp = layer_params(params, layer)
        q, k, v = _qkv(lp["attn"], apply_norm(lp["ln1"], x, cfg.norm), cfg)
        q, k = _rope_qk(q, k, cfg, positions)
        if cache is not None:
            write_paged(cache["k"][layer], cache["tables"], positions, k)
            write_paged(cache["v"][layer], cache["tables"], positions, v)
        out = prefill_attention(q, _heads_first(k), _heads_first(v), q_start,
                                kv_len)
        x = _ffn_residual(lp, _attn_out(lp, x, out), cfg)
    logits = _final(params, cfg, x)
    if cache is not None:
        cache = {**cache, "pos": kv_len}
    return logits, cache, dict(_NO_AUX)


def forward_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """Continue a partial prefill: row b's chunk ``tokens[b]`` (B, C) sits
    at absolute positions ``pos[b] .. pos[b]+C-1``.

    Per layer the chunk's K/V are written into the pools first, then the
    chunk's queries attend the row's lane (gathered from the pool through
    its table) causally, keys ``[0, pos[b]+C)``: exactly the resident prefix
    plus the chunk, so chunked prefill equals one :func:`forward_seq`. The
    caller guarantees ``pos + C <= W`` (no wrap). Returns
    ``(logits (B, C, V), cache)`` with ``pos`` advanced by C."""
    check_supported(cfg)
    b, c = tokens.shape
    x = params["embed"][tokens]
    pos0 = cache["pos"].to(torch.int32)
    positions = pos0[:, None] + torch.arange(c, dtype=torch.int32,
                                             device=x.device)[None, :]
    kv_len = pos0 + c
    tables = cache["tables"]
    for layer in range(cfg.num_layers):
        lp = layer_params(params, layer)
        q, k, v = _qkv(lp["attn"], apply_norm(lp["ln1"], x, cfg.norm), cfg)
        q, k = _rope_qk(q, k, cfg, positions)
        k_pool, v_pool = cache["k"][layer], cache["v"][layer]
        write_paged(k_pool, tables, positions, k)
        write_paged(v_pool, tables, positions, v)
        out = prefill_attention(q, gather_lane(k_pool, tables),
                                gather_lane(v_pool, tables), pos0, kv_len)
        x = _ffn_residual(lp, _attn_out(lp, x, out), cfg)
    return _final(params, cfg, x), {**cache, "pos": kv_len}


def decode_step(params: Params, cfg: ModelConfig, cache: Cache,
                token: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token: (B, 1) int at per-row positions ``pos``.

    Per layer the token's K/V row is written into block
    ``tables[b, (pos % W) // bs]`` before the paged decode kernel attends
    ``min(pos+1, W)`` rows (a wrap past W attends the whole lane, the
    reference's ring semantics). Returns ``(logits (B, V), cache)`` with
    ``pos`` advanced by one."""
    check_supported(cfg)
    x = params["embed"][token]
    pos = cache["pos"].to(torch.int32)
    positions = pos[:, None]
    tables = cache["tables"]
    w = tables.shape[1] * cache["k"].shape[2]
    lengths = torch.clamp(pos + 1, max=w)
    for layer in range(cfg.num_layers):
        lp = layer_params(params, layer)
        q, k, v = _qkv(lp["attn"], apply_norm(lp["ln1"], x, cfg.norm), cfg)
        q, k = _rope_qk(q, k, cfg, positions)
        k_pool, v_pool = cache["k"][layer], cache["v"][layer]
        write_paged(k_pool, tables, positions, k)
        write_paged(v_pool, tables, positions, v)
        out = paged_decode_attention(q[:, 0], k_pool, v_pool, tables,
                                     lengths)
        x = _ffn_residual(lp, _attn_out(lp, x, out[:, None]), cfg)
    return _final(params, cfg, x)[:, 0], {**cache, "pos": pos + 1}
