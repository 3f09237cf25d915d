"""Multi-family transformer, dense, MoE, VLM, hybrid, SSM and
encoder-decoder: parameters, prefill, chunked continuation and decode over
a paged or a contiguous cache, and the training forward.

Port of ``repro/models/transformer.py`` for every family of the reference:
DENSE; MOE (the FFN a capacity-bounded mixture of experts,
``models/moe.py``, plus a shared dense MLP where ``d_ff > 0``); VLM
(Qwen2-VL's language backbone: M-RoPE positions, stub vision embeddings
prepended to the tokens); HYBRID (attention and a Mamba-2/SSD head bank in
every layer, their outputs averaged); SSM (attention-free RWKV-6 time-mix
and channel-mix, ``models/rwkv6.py``); and AUDIO (Whisper: a bidirectional
encoder over stub frame embeddings, :func:`encode`, and a decoder with
learned positions and cross-attention onto the encoder's rows).
Parameters keep the reference's pytree layout as nested dicts of tensors,
with every layer leaf stacked on a leading ``num_layers`` axis, so bridged
JAX parameters drop in unchanged; the layer loop is a Python loop where JAX
used ``lax.scan``.

Two decode caches, one per engine mode:

* **paged** (dense, MoE and VLM families without a window)::

      {"k", "v": (L, N+1, bs, KH, dh) pools, block N a null block,
       "tables": (B, max_blocks) int32 block table per sequence,
       "pos": (B,) int32 tokens resident per sequence}

  The lane width is ``W = max_blocks * bs``.
* **contiguous** (the reference's per-slot lanes, stored heads first)::

      {"k", "v": (L, S, KH, W, dh) lanes, W = min(max_len, window),
       "slots": (B,) int32 lane of each sequence,
       "pos": (B,) int32 tokens resident per sequence,
       HYBRID: "conv_tail": (L, S, conv_width - 1, d_inner),
               "ssm_state": (L, S, nheads, state, head_dim) f32,
       AUDIO: "cross_k", "cross_v": (L, S, KH, F, dh) encoder K/V,
              F = encoder_seq_len}

  A lane is an append buffer while ``pos < W`` and a ring after. The SSM
  family keeps no K/V lanes, only per-slot recurrent state::

      {"state": (L, S, H, dh, dh) f32, "tm_prev", "cm_prev": (L, S, d),
       "slots", "pos"}

:func:`init_cache` builds either with identity tables or slots; the serving
engine passes its own pool or lanes with the dispatched requests' tables or
slots. Every function that takes a cache writes the new state into it **in
place** (the pools and lanes are the serving engine's memory, too large to
copy per step) and returns a dict with the advanced ``pos``. Per-row ``pos``
lets one call serve sequences at different offsets (the reference ran one
row per ``vmap`` lane with a scalar ``pos``).

Two routes, chosen by the caller's ``attn_impl``:

* ``"kernel"`` (serving) runs the port's kernels: prefill attention for
  :func:`forward_seq` (``q_start = 0`` over the prompt's own K/V; without
  the causal mask for the encoder and for cross-attention onto its rows)
  and :func:`forward_chunk` (per-row offsets over lanes gathered from the
  cache), paged or ring decode attention for :func:`decode_step` (no
  gather; cross-attention is ring decode over the encoder lanes with every
  row visible), and the chunked linear-attention kernel for HYBRID's SSM
  (``ssd`` mode) and the SSM family's time-mix (``rwkv`` mode).
* ``"naive"`` or ``"chunked"`` (training) runs the reference's plain,
  differentiable attention and linear-attention scan for every family; the
  kernels have no backward, and their wrappers refuse operands that
  require grad. ``remat`` recomputes each decoder layer in backward
  (``"full"``) or all but its weight products (``"dots"``).

An MoE layer's output for a token depends on the other tokens of its
dispatch (expert capacity): :func:`forward_seq` routes a call's rows
together, as the reference's function does on a batch (first chunks,
training); :func:`forward_chunk` and :func:`decode_step` route each row as
its own dispatch, as the reference engine's continuation and decode
programs do (one row at a time under ``vmap``).
"""
from __future__ import annotations

import functools
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs.base import (AUDIO, DENSE, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_decode.ops import paged_decode_attention
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import ssm as ssd
from repro_torch.models.attention import (gather_lane, prefill_attention,
                                          write_paged)
from repro_torch.models.common import (activate, apply_mrope, apply_norm,
                                       apply_rope, dense_init, embed_init,
                                       gated, generator, init_norm,
                                       positions_for)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.sharding import local as sharded
from repro_torch.sharding.annotate import gather_fsdp, splits, with_sharding

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

# The families whose token mixing is attention alone.
ATTENTION_FAMILIES = (DENSE, MOE, VLM)
FAMILIES = (*ATTENTION_FAMILIES, HYBRID, SSM, AUDIO)
POS_EMBS = ("rope", "mrope", "learned", "none")
REMATS = ("none", "dots", "full")
# Rows of the decoder's learned position table (the reference's); positions
# past it wrap around.
LEARNED_POSITIONS = 8192


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family or positional code that
    neither the reference nor the port defines."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"unknown family {cfg.family!r}; the port "
                                  f"runs {', '.join(FAMILIES)}")
    if cfg.pos_emb not in POS_EMBS:
        raise NotImplementedError(f"unknown pos_emb {cfg.pos_emb!r}; the "
                                  f"port runs {', '.join(POS_EMBS)}")


def default_paged(cfg: ModelConfig) -> bool:
    """The reference engine's choice: block-structured KV for attention-only
    append caches; hybrid, ssm, encoder-decoder and sliding-window models
    keep per-slot lanes or state."""
    return (cfg.family in ATTENTION_FAMILIES and not cfg.is_encdec
            and not cfg.sliding_window)


def param_count(cfg: ModelConfig) -> int:
    """Parameters :func:`init_params` makes for ``cfg``, from its widths
    alone (nothing is allocated), so that a launcher can tell whether a
    published config fits the card."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    norm = d * (2 if cfg.norm == "layernorm" else 1)
    attn = 2 * d * q + 2 * d * kv + (q + 2 * kv + d if cfg.use_bias else 0)
    mlp = ((3 if gated(cfg.activation) else 2) * d * f
           + (f + d if cfg.use_bias else 0)) if f else 0
    if cfg.family == SSM:
        r = rwkv.DECAY_LORA
        time_mix = 5 * d + 5 * d * q + 3 * q + d * r + r * q
        channel_mix = 2 * d + 2 * d * f + d * d
        layer = 2 * norm + time_mix + channel_mix
    else:
        layer = 2 * norm + attn + mlp
        if cfg.moe is not None:
            e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff
            layer += d * e + (3 if gated(cfg.activation) else 2) * e * d * fe
        if cfg.family == HYBRID:
            d_inner, nh, n = ssd._dims(cfg)
            layer += (2 * d * d_inner + cfg.ssm.conv_width * d_inner
                      + 2 * d_inner * n + d_inner * nh + 2 * nh + d_inner * d)
        if cfg.is_encdec:
            layer += attn + norm                        # cross, ln_cross
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    n_params = cfg.vocab_size * d + norm + head + L * layer
    if cfg.pos_emb == "learned":
        n_params += LEARNED_POSITIONS * d
    if cfg.is_encdec:
        n_params += (cfg.encoder_layers * (2 * norm + attn + mlp)
                     + cfg.encoder_seq_len * d + norm)
    return n_params


def require_fit(cfg, device: torch.device, bytes_per_param: int) -> None:
    """Exit with a message, before anything is allocated, where ``cfg``'s
    parameters at ``bytes_per_param`` bytes each exceed the device's memory
    (the card's, or the host's for the CPU)."""
    n = param_count(cfg)
    if device.type == "cuda":
        have = torch.cuda.get_device_properties(device).total_memory
    else:
        have = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    if n * bytes_per_param > have:
        raise SystemExit(
            f"{cfg.arch_id} at published widths does not fit: {n / 1e9:.1f} "
            f"B parameters need {n * bytes_per_param / 1e9:.0f} GB, the "
            f"{device.type} device holds {have / 1e9:.0f} GB")


# ===========================================================================
# Parameter initialization
# ===========================================================================
def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = "cuda",
                param_dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters in the reference's layout, drawn on ``device`` from
    a ``torch.Generator`` seeded with ``seed`` (the reference's
    distributions, not its bits: parity tests bridge JAX parameters). The
    AUDIO family adds each decoder layer's ``cross`` attention and
    ``ln_cross``, and an ``encoder`` subtree (stacked layers, its own
    ``pos_embed`` of ``encoder_seq_len`` rows, ``final_norm``); learned
    positions add a ``pos_embed`` of :data:`LEARNED_POSITIONS` rows."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = param_dtype or getattr(torch, cfg.dtype)
    gen = generator(dev, seed)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(shape, n=L):
        return dense_init(gen, (n,) + shape, in_axis_size=shape[0],
                          dtype=dtype)

    def stacked_norm(n=L):
        return {k: v.expand(n, -1).contiguous() for k, v in
                init_norm(d, cfg.norm, dtype, dev).items()}

    def zeros(width, n=L):
        return torch.zeros(n, width, dtype=dtype, device=dev)

    def attn_block(n=L):
        attn = {"wq": dense((d, h * dh), n), "wk": dense((d, kh * dh), n),
                "wv": dense((d, kh * dh), n), "wo": dense((h * dh, d), n)}
        if cfg.use_bias:
            attn.update(bq=zeros(h * dh, n), bk=zeros(kh * dh, n),
                        bv=zeros(kh * dh, n), bo=zeros(d, n))
        return attn

    def mlp_block(n=L):
        mlp = {"w_up": dense((d, f), n), "w_down": dense((f, d), n)}
        if gated(cfg.activation):
            mlp["w_gate"] = dense((d, f), n)
        if cfg.use_bias:
            mlp.update(b_up=zeros(f, n), b_down=zeros(d, n))
        return mlp

    if cfg.family == SSM:       # attention-free: time-mix, channel-mix
        layers = {"ln1": stacked_norm(), "ln2": stacked_norm(),
                  "tm": rwkv.init_time_mix(gen, cfg, dtype, L),
                  "cm": rwkv.init_channel_mix(gen, cfg, dtype, L)}
    else:
        layers = {"ln1": stacked_norm(), "ln2": stacked_norm(),
                  "attn": attn_block()}
        if f:                   # the dense MLP, or MoE's shared expert
            layers["mlp"] = mlp_block()
        if cfg.moe is not None:
            layers["moe"] = init_moe(gen, d, cfg.moe, cfg.activation, dtype,
                                     L)
        if cfg.family == HYBRID:
            layers["ssm"] = ssd.init_ssm(gen, cfg, dtype, L)
        if cfg.is_encdec:
            layers["cross"] = attn_block()
            layers["ln_cross"] = stacked_norm()
    params: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, d), dtype),
        "final_norm": init_norm(d, cfg.norm, dtype, dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=dtype)
    if cfg.pos_emb == "learned":
        params["pos_embed"] = embed_init(gen, (LEARNED_POSITIONS, d), dtype)
    if cfg.is_encdec:
        e = cfg.encoder_layers
        enc = {"ln1": stacked_norm(e), "ln2": stacked_norm(e),
               "attn": attn_block(e)}
        if f:
            enc["mlp"] = mlp_block(e)
        params["encoder"] = {
            "layers": enc,
            "pos_embed": embed_init(gen, (cfg.encoder_seq_len, d), dtype),
            "final_norm": init_norm(d, cfg.norm, dtype, dev)}
    return params


def unstack_layers(params: Params) -> List[Params]:
    """The stacked ``params["layers"]`` tree as one tree per layer, each
    leaf unbound once along its ``num_layers`` axis. Under autograd the
    backward of one ``unbind`` stacks the layers' gradients into one
    (L, ...) tensor, where indexing each layer would write a zero-filled
    full-size gradient per layer."""
    flat = flatten(params["layers"])
    per_leaf = {key: torch.unbind(leaf, 0) for key, leaf in flat.items()}
    return [unflatten({key: views[i] for key, views in per_leaf.items()})
            for i in range(len(next(iter(per_leaf.values()))))]


# ===========================================================================
# Cache construction
# ===========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               paged: Optional[bool] = None, block_size: int = 16,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = "cuda") -> Cache:
    """An empty decode cache for ``batch`` sequences of up to ``max_len``
    positions (``paged`` defaults to :func:`default_paged`).

    Paged: row b owns blocks ``b*mb .. b*mb + mb - 1`` of an
    ``N = batch*mb`` block pool (plus the null block),
    ``mb = max_len / block_size``. Contiguous: row b owns lane b, of width
    ``W = min(max_len, sliding_window)`` (the ring a window needs, never
    wider than the window); the SSM family, contiguous only, holds per-slot
    recurrent state and no lanes; the AUDIO family adds each slot's
    ``cross_k`` / ``cross_v`` lanes of ``encoder_seq_len`` rows, which its
    prefill fills with the encoder's K/V."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    L, kh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    pos = torch.zeros(batch, dtype=torch.int32, device=dev)
    if paged is None:
        paged = default_paged(cfg)
    if paged:
        if not default_paged(cfg):
            raise ValueError(
                f"paged KV needs an attention-family decoder-only model "
                f"without a sliding window (got {cfg.family}, window "
                f"{cfg.sliding_window}): recurrent state is not "
                f"block-structured, window lanes are shorter than the "
                f"positions they cover, and the reference keeps "
                f"encoder-decoder caches contiguous")
        if max_len % block_size:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"block_size={block_size}")
        mb = max_len // block_size
        n = batch * mb
        shape = (L, n + 1, block_size, kh, dh)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev),
                "tables": torch.arange(n, dtype=torch.int32,
                                       device=dev).reshape(batch, mb),
                "pos": pos}
    slots = torch.arange(batch, dtype=torch.int32, device=dev)
    if cfg.family == SSM:
        h, d = cfg.num_heads, cfg.d_model
        return {"state": torch.zeros(L, batch, h, dh, dh,
                                     dtype=torch.float32, device=dev),
                "tm_prev": torch.zeros(L, batch, d, dtype=dt, device=dev),
                "cm_prev": torch.zeros(L, batch, d, dtype=dt, device=dev),
                "slots": slots, "pos": pos}
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    cache = {"k": torch.zeros(L, batch, kh, w, dh, dtype=dt, device=dev),
             "v": torch.zeros(L, batch, kh, w, dh, dtype=dt, device=dev),
             "slots": slots, "pos": pos}
    if cfg.family == HYBRID:
        s = cfg.ssm
        d_inner, nh, n = ssd._dims(cfg)
        cache["conv_tail"] = torch.zeros(L, batch, s.conv_width - 1, d_inner,
                                         dtype=dt, device=dev)
        cache["ssm_state"] = torch.zeros(L, batch, nh, n, s.head_dim,
                                         dtype=torch.float32, device=dev)
    if cfg.is_encdec:
        shape = (L, batch, kh, cfg.encoder_seq_len, dh)
        cache["cross_k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["cross_v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


# ===========================================================================
# Blocks
# ===========================================================================
def _linear(x: torch.Tensor, p: Params, w: str, b: str) -> torch.Tensor:
    y = x @ p[w]
    return y + p[b] if b in p else y


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    return (_q(p, x, cfg), *_kv(p, x, cfg))


def _residual(y: torch.Tensor) -> torch.Tensor:
    """A block's output as it joins the residual stream: under sharding
    rules, whole rows per batch shard. The port's tag, where the
    reference leaves the partitioner to place it: a row-parallel product's
    partial sums are reduced here (Megatron's all-reduce), before the next
    norm."""
    return with_sharding(y, ("batch", None, None))


def _split_heads(y: torch.Tensor, n: int, dh: int, name: str
                 ) -> torch.Tensor:
    """(B, S, n*dh) -> (B, S, n, dh). Under sharding rules that leave the
    ``n`` heads unsplit, the projection's output is first gathered along
    its feature dim: a shard of it would cut a head."""
    b, s, _ = y.shape
    if not splits(name, n):
        y = with_sharding(y, ("batch", None, None))
    return y.reshape(b, s, n, dh)


def _q(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _split_heads(_linear(x, p, "wq", "bq"), cfg.num_heads,
                        cfg.head_dim, "heads")


def _kv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    kh, dh = cfg.num_kv_heads, cfg.head_dim
    return (_split_heads(_linear(x, p, "wk", "bk"), kh, dh, "kv_heads"),
            _split_heads(_linear(x, p, "wv", "bv"), kh, dh, "kv_heads"))


def _rope_qk(q, k, cfg: ModelConfig, positions, mrope_pos=None):
    """Rotate q and k: RoPE at ``positions`` (B, S), or M-RoPE at
    ``mrope_pos`` (3, B, S), the text positions broadcast to all three
    streams where none are given (the reference's decode and chunk).
    Learned positions (added at the embedding) and none rotate nothing."""
    if cfg.pos_emb == "mrope":
        if mrope_pos is None:
            mrope_pos = positions[None].expand(3, *positions.shape)
        return (apply_mrope(q, mrope_pos, cfg.rope_theta),
                apply_mrope(k, mrope_pos, cfg.rope_theta))
    if cfg.pos_emb == "rope":
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta))
    return q, k


def _tag_qk(q: torch.Tensor, k: torch.Tensor):
    """The reference's activation tags on a full sequence's q and k."""
    return (with_sharding(q, ("batch", None, "heads", None)),
            with_sharding(k, ("batch", None, "kv_heads", None)))


def _row_positions(batch: int, start, seq: int, device) -> torch.Tensor:
    """:func:`positions_for`, placed with the batch under sharding rules."""
    return with_sharding(positions_for(batch, start, seq, device),
                         ("batch", None))


def _mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = _linear(x, p, "w_up", "b_up")
    gate = x @ p["w_gate"] if "w_gate" in p else None
    h = with_sharding(activate(up, gate, cfg.activation), ("batch", None, "ff"))
    return _residual(_linear(h, p, "w_down", "b_down"))


def _attn_proj(lp: Params, out: torch.Tensor, name: str = "attn"
               ) -> torch.Tensor:
    b, s = out.shape[:2]
    # placed as wo's rows (heads first), so that backward brings the
    # gradient back whole before the heads' view where the heads do not
    # split
    flat = with_sharding(out.reshape(b, s, -1), ("batch", None, "heads"))
    return _residual(_linear(flat, lp[name], "wo", "bo"))


_NO_AUX = {"load_balance_loss": 0.0, "router_z_loss": 0.0}


def _ffn_residual(lp: Params, x, cfg: ModelConfig, *, per_row: bool):
    """The layer's second half: ``(x + ffn(norm(x)), aux)``, the FFN the
    dense MLP, the MoE, or both (a shared expert), as the reference's
    ``_ffn``; ``aux`` holds the MoE's losses and dropped slots. ``per_row``
    routes each row as its own MoE dispatch."""
    xn = apply_norm(lp["ln2"], x, cfg.norm)
    y, aux = 0.0, _NO_AUX
    if "moe" in lp:
        y, aux = apply_moe(lp["moe"], xn, cfg.moe, cfg.activation,
                           per_row=per_row)
        y = _residual(y)
    if "mlp" in lp:
        y = y + _mlp(lp["mlp"], xn, cfg)
    return x + y, aux


def _add_aux(total: dict, aux: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in aux.items()}


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor):
    head = gather_fsdp(params["embed"]).T if cfg.tie_embeddings \
        else gather_fsdp(params["lm_head"])
    return with_sharding(x @ head, ("batch", None, "vocab"))


def _final(params: Params, cfg: ModelConfig, x: torch.Tensor):
    return _unembed(params, cfg, apply_norm(params["final_norm"], x,
                                            cfg.norm))


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, KH, dh) -> contiguous (B, KH, S, dh), the kernels' layout."""
    return x.transpose(1, 2).contiguous()


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor, start,
           vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, d), ``vision_embeds`` prepended; learned
    positions add table rows ``(start + i) mod LEARNED_POSITIONS`` (the
    reference's modular wrap), ``start`` an int or per-row (B,)."""
    x = sharded.lookup(gather_fsdp(params["embed"]), tokens)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], 1)
    if cfg.pos_emb == "learned":
        table = gather_fsdp(params["pos_embed"])
        ids = positions_for(x.shape[0], start, x.shape[1], x.device)
        x = x + sharded.lookup(table, ids.long() % table.shape[0]).to(
            x.dtype)
    return with_sharding(x, ("batch", None, None))


def _bidirectional(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """Attention of q (B, Sq, H, dh) over every row of the heads-first k/v
    (B, KH, Skv, dh), no mask: the prefill kernel with ``causal=False``."""
    b, skv = k.shape[0], k.shape[2]
    return prefill_attention(
        q, k, v, torch.zeros(b, dtype=torch.int32, device=q.device),
        torch.full((b,), skv, dtype=torch.int32, device=q.device),
        causal=False)


# ===========================================================================
# Whisper encoder
# ===========================================================================
def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           attn_impl: str = "kernel", kv_chunk: int = 1024) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings (B, F, d) ->
    (B, F, d): learned positions, then pre-norm layers of unmasked
    self-attention and an MLP, then the encoder's final norm. Its attention
    runs on the prefill kernel without the causal mask
    (``attn_impl="kernel"``) or on the plain attention (training)."""
    enc = params["encoder"]
    b, f, _ = frames.shape
    x = frames + gather_fsdp(enc["pos_embed"])[:f].to(frames.dtype)
    positions = _row_positions(b, 0, f, x.device)
    for lp in map(gather_fsdp, unstack_layers(enc)):
        q, k, v = _qkv(lp["attn"], apply_norm(lp["ln1"], x, cfg.norm), cfg)
        q, k = _tag_qk(q, k)
        if attn_impl == "kernel":
            out = _bidirectional(q, _heads_first(k), _heads_first(v))
        else:
            out = sharded.attend(q, k, v, positions, positions, causal=False,
                            impl=attn_impl, kv_chunk=kv_chunk)
        x = x + _attn_proj(lp, out)
        x = x + _mlp(lp["mlp"], apply_norm(lp["ln2"], x, cfg.norm), cfg)
    return apply_norm(enc["final_norm"], x, cfg.norm)


# ===========================================================================
# Top level
# ===========================================================================
def _cross_plain(lp: Params, x: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig, positions: torch.Tensor, attn_impl: str,
                 kv_chunk: int) -> torch.Tensor:
    """The decoder's cross-attention on the plain attention: queries from
    ``ln_cross(x)``, K/V from the encoder's rows, no mask."""
    q = _q(lp["cross"], apply_norm(lp["ln_cross"], x, cfg.norm), cfg)
    k, v = _kv(lp["cross"], enc_out, cfg)
    q, k = _tag_qk(q, k)
    pos_kv = _row_positions(k.shape[0], 0, k.shape[1], k.device)
    out = sharded.attend(q, k, v, positions, pos_kv, causal=False,
                    impl=attn_impl, kv_chunk=kv_chunk)
    return _attn_proj(lp, out, "cross")


def _plain_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, mrope_pos: Optional[torch.Tensor],
                 enc_out: Optional[torch.Tensor], attn_impl: str,
                 kv_chunk: int):
    """One decoder layer of any family on the plain, differentiable
    attention and linear-attention scan: ``(x, aux)``. Under sharding rules
    the layer's parameters are gathered over the FSDP axes here, inside
    the recomputed region, so backward gathers them again rather than
    keeping every layer's gathered copy."""
    lp = gather_fsdp(lp)
    xn = apply_norm(lp["ln1"], x, cfg.norm)
    if cfg.family == SSM:
        return _rwkv_seq(lp, x, xn, cfg, None, 0, attn_impl), _NO_AUX
    q, k, v = _qkv(lp["attn"], xn, cfg)
    q, k = _tag_qk(*_rope_qk(q, k, cfg, positions, mrope_pos))
    out = sharded.attend(q, k, v, positions, positions, causal=True,
                    window=cfg.sliding_window, impl=attn_impl,
                    kv_chunk=kv_chunk)
    mix = _attn_proj(lp, out)
    if cfg.family == HYBRID:
        ssm_out, _, _ = ssd.apply_ssm(lp["ssm"], xn, cfg, attn_impl=attn_impl)
        mix = 0.5 * (mix + _residual(ssm_out))
    x = x + mix
    if enc_out is not None:
        x = x + _cross_plain(lp, x, enc_out, cfg, positions, attn_impl,
                             kv_chunk)
    return _ffn_residual(lp, x, cfg, per_row=False)


# The ops whose outputs ``remat="dots"`` keeps: the weight products, which
# have no batch dimension (the reference's
# ``checkpoint_dots_with_no_batch_dims``); attention's batched products and
# everything elementwise are recomputed in backward.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, remat: str):
    """``fn`` recomputed in backward as ``remat`` says: whole (``"full"``),
    all but its weight products (``"dots"``), or not at all."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    context = {"context_fn": _dots_context} if remat == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **context)


def _forward_plain(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor,
                   mrope_pos: Optional[torch.Tensor],
                   enc_out: Optional[torch.Tensor], attn_impl: str,
                   kv_chunk: int, remat: str):
    """The training forward over embedded inputs ``x``: every decoder layer
    on the plain route, recomputed in backward as ``remat`` says; the
    auxiliary losses summed over layers."""
    aux = dict(_NO_AUX)
    layer = _remat(_plain_layer, remat)
    for lp in unstack_layers(params):
        x, layer_aux = layer(lp, x, cfg, positions, mrope_pos, enc_out,
                             attn_impl, kv_chunk)
        aux = _add_aux(aux, layer_aux)
    return _final(params, cfg, x), None, aux


def forward_seq(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                vision_embeds: Optional[torch.Tensor] = None,
                mrope_positions: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None,
                build_cache: bool = False, cache_len: int = 0,
                cache: Optional[Cache] = None, attn_impl: str = "kernel",
                kv_chunk: int = 1024, remat: str = "none"
                ) -> Tuple[torch.Tensor, Optional[Cache], dict]:
    """Full-sequence forward from position 0. tokens: (B, S) int.

    Returns ``(logits (B, S', V), cache-or-None, aux)``: ``S' = P + S``
    with ``vision_embeds`` (B, P, d) prepended to the token embeddings (the
    VLM family's stub patch embeddings), ``aux`` the MoE's auxiliary
    losses summed over layers (zero for the other families) and its
    ``dropped_slots``. ``mrope_positions`` (3, B, S') are M-RoPE's position
    streams, the linear positions broadcast where none are given. The
    encoder-decoder family needs ``frames`` (B, F, d), the stub frame
    embeddings its encoder reads (:func:`encode`); every decoder layer
    attends the encoder's rows after its self-attention.

    ``attn_impl="kernel"`` (serving) runs the kernels, which have no
    backward. With ``cache`` the prompt's K/V rows ``[0, S')`` are written
    into it through its tables or into its slots' lanes (a prompt longer
    than a lane keeps its last W rows at their ring slots), HYBRID's conv
    tail and SSM state, the SSM family's state and last normed rows
    (``tm_prev``, ``cm_prev``), and the encoder's K/V (``cross_k``,
    ``cross_v``) land in the slots, and ``pos`` becomes S' (the serving
    engine's first-chunk prefill); ``build_cache=True`` does the same into
    a fresh ``init_cache(cfg, B, cache_len)``. A cache with fewer tables or
    slots than B rows takes the leading rows' state only: the rows past
    them are computed (an MoE dispatch's padding lanes, which route with
    the others) and written nowhere.

    ``attn_impl="naive"`` or ``"chunked"`` (training) runs the reference's
    plain, differentiable attention (:func:`models.attention.attention`,
    chunks of ``kv_chunk`` keys) and linear-attention scan, and builds no
    cache. ``remat="full"`` recomputes each decoder layer's activations in
    backward (``torch.utils.checkpoint``), ``"dots"`` all of them but the
    weight products' outputs."""
    check_supported(cfg)
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}: one of {REMATS}")
    if cfg.is_encdec and frames is None:
        raise ValueError(f"{cfg.arch_id}: the encoder-decoder family reads "
                         f"frames (B, encoder_seq_len, d_model)")
    x = _embed(params, cfg, tokens, 0, vision_embeds)
    b, s, _ = x.shape
    dev = x.device
    positions = _row_positions(b, 0, s, dev)
    if attn_impl not in ("kernel", "naive", "chunked"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    plain = attn_impl != "kernel"
    enc_out = (encode(params, cfg, frames, attn_impl=attn_impl,
                      kv_chunk=kv_chunk) if cfg.is_encdec else None)
    if plain and cache is None and not build_cache:
        return _forward_plain(params, cfg, x, positions, mrope_positions,
                              enc_out, attn_impl, kv_chunk, remat)
    if remat != "none":
        raise ValueError("remat recomputes the training forward; the kernel "
                         "path has no backward and a prefill into a cache "
                         "takes none")
    if cache is None and build_cache:
        cache = init_cache(cfg, b, cache_len, dtype=x.dtype, device=dev)
    # rows the cache holds (its tables or slots); rows past them compute
    n = b if cache is None else len(cache.get("tables", cache.get("slots")))
    q_start = torch.zeros(b, dtype=torch.int32, device=dev)
    kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    aux = dict(_NO_AUX)
    for layer, lp in enumerate(map(gather_fsdp, unstack_layers(params))):
        xn = apply_norm(lp["ln1"], x, cfg.norm)
        if cfg.family == SSM:
            x = _rwkv_seq(lp, x, xn, cfg, cache, layer, attn_impl)
            continue
        q, k, v = _qkv(lp["attn"], xn, cfg)
        q, k = _tag_qk(*_rope_qk(q, k, cfg, positions, mrope_positions))
        if cache is not None and "tables" in cache:
            write_paged(cache["k"][layer], cache["tables"], positions[:n],
                        k[:n])
            write_paged(cache["v"][layer], cache["tables"], positions[:n],
                        v[:n])
        elif cache is not None:
            sharded.write_prompt(cache["k"][layer], cache["slots"], k[:n])
            sharded.write_prompt(cache["v"][layer], cache["slots"], v[:n])
        if plain:
            out = sharded.attend(q, k, v, positions, positions, causal=True,
                            window=cfg.sliding_window, impl=attn_impl,
                            kv_chunk=kv_chunk)
        else:
            out = prefill_attention(q, _heads_first(k), _heads_first(v),
                                    q_start, kv_len,
                                    window=cfg.sliding_window)
        mix = _attn_proj(lp, out)
        if cfg.family == HYBRID:
            ssm_out, tail, state = ssd.apply_ssm(lp["ssm"], xn, cfg,
                                                 attn_impl=attn_impl)
            mix = 0.5 * (mix + _residual(ssm_out))
            if cache is not None:
                slots = cache["slots"]
                sharded.put_rows(cache["conv_tail"][layer], slots, tail[:n])
                sharded.put_rows(cache["ssm_state"][layer], slots,
                                 state[:n])
        x = x + mix
        if enc_out is not None:
            x = x + _cross_seq(lp, x, enc_out, cfg, cache, layer, positions,
                               attn_impl, kv_chunk)
        x, layer_aux = _ffn_residual(lp, x, cfg, per_row=False)
        aux = _add_aux(aux, layer_aux)
    logits = _final(params, cfg, x)
    if cache is not None:
        cache = {**cache, "pos": kv_len[:n]}
    return logits, cache, aux


def _cross_seq(lp: Params, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, cache: Optional[Cache], layer: int,
               positions: torch.Tensor, attn_impl: str, kv_chunk: int
               ) -> torch.Tensor:
    """The decoder's cross-attention on the prefill kernel, or on the plain
    attention (``attn_impl``), no mask: the prompt's rows over the
    encoder's F rows; with a cache, the encoder's K/V land in the slots'
    cross lanes."""
    q = _q(lp["cross"], apply_norm(lp["ln_cross"], x, cfg.norm), cfg)
    k, v = _kv(lp["cross"], enc_out, cfg)
    q, k = _tag_qk(q, k)
    if attn_impl != "kernel":
        pos_kv = _row_positions(k.shape[0], 0, k.shape[1], k.device)
        out = sharded.attend(q, k, v, positions, pos_kv, causal=False,
                        impl=attn_impl, kv_chunk=kv_chunk)
    k, v = _heads_first(k), _heads_first(v)
    if attn_impl == "kernel":
        out = _bidirectional(q, k, v)
    if cache is not None:
        slots = cache["slots"]
        sharded.put_rows(cache["cross_k"][layer], slots, k[:len(slots)])
        sharded.put_rows(cache["cross_v"][layer], slots, v[:len(slots)])
    return _attn_proj(lp, out, "cross")


def _rwkv_seq(lp: Params, x: torch.Tensor, xn: torch.Tensor,
              cfg: ModelConfig, cache: Optional[Cache], layer: int,
              attn_impl: str) -> torch.Tensor:
    """One SSM layer over a prompt from a zero state (both token shifts
    start from zeros), its scan on the route ``attn_impl`` names; with a
    cache, the final state and the last rows of the layer's normed inputs
    land in the slots."""
    prev = torch.zeros_like(x[:, 0])
    out, last_tm, state = rwkv.time_mix(lp["tm"], xn, prev, cfg,
                                        attn_impl=attn_impl)
    x = x + _residual(out)
    xn2 = apply_norm(lp["ln2"], x, cfg.norm)
    out2, last_cm = rwkv.channel_mix(lp["cm"], xn2, prev)
    out2 = _residual(out2)
    if cache is not None:
        slots = cache["slots"]
        n = len(slots)
        sharded.put_rows(cache["state"][layer], slots, state[:n])
        sharded.put_rows(cache["tm_prev"][layer], slots, last_tm[:n])
        sharded.put_rows(cache["cm_prev"][layer], slots, last_cm[:n])
    return x + out2


def _rwkv_step(lp: Params, x: torch.Tensor, xn: torch.Tensor,
               cfg: ModelConfig, cache: Cache, layer: int,
               rows: torch.Tensor) -> torch.Tensor:
    """One SSM layer, one token per row: the slots' state and token shifts
    gathered, advanced and scattered back."""
    states, tm_prev, cm_prev = (cache[k][layer]
                                for k in ("state", "tm_prev", "cm_prev"))
    out, last_tm, state = rwkv.time_mix_step(
        lp["tm"], xn[:, 0], sharded.take_rows(tm_prev, rows),
        sharded.take_rows(states, rows), cfg)
    x = x + _residual(out[:, None])
    xn2 = apply_norm(lp["ln2"], x, cfg.norm)
    out2, last_cm = rwkv.channel_mix_step(lp["cm"], xn2[:, 0],
                                          sharded.take_rows(cm_prev, rows))
    sharded.put_rows(states, rows, state)
    sharded.put_rows(tm_prev, rows, last_tm)
    sharded.put_rows(cm_prev, rows, last_cm)
    return x + _residual(out2[:, None])


def forward_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """Continue a partial prefill: row b's chunk ``tokens[b]`` (B, C) sits
    at absolute positions ``pos[b] .. pos[b]+C-1``.

    Per layer the chunk's K/V are written into the cache first, then the
    chunk's queries attend the row's lane (gathered from the pool through
    its table, or from its slot) causally, keys ``[0, pos[b]+C)``: exactly
    the resident prefix plus the chunk, so chunked prefill equals one
    :func:`forward_seq`. The caller guarantees ``pos + C <= W`` (no wrap).
    Attention families only (dense, MoE, VLM): a hybrid's SSM carries
    state across chunks that :func:`forward_seq` does not take back in.
    M-RoPE takes the text positions in all three streams. Each row's chunk
    is its own MoE dispatch, as under the reference engine's ``vmap``.
    Returns
    ``(logits (B, C, V), cache)`` with ``pos`` advanced by C."""
    check_supported(cfg)
    if cfg.family not in ATTENTION_FAMILIES or cfg.is_encdec:
        raise NotImplementedError(
            f"forward_chunk supports attention-family models; "
            f"{cfg.family} carries recurrent cross-chunk state")
    b, c = tokens.shape
    pos0 = cache["pos"].to(torch.int32)
    x = _embed(params, cfg, tokens, pos0)
    positions = pos0[:, None] + torch.arange(c, dtype=torch.int32,
                                             device=x.device)[None, :]
    kv_len = pos0 + c
    paged = "tables" in cache
    for layer, lp in enumerate(map(gather_fsdp, unstack_layers(params))):
        q, k, v = _qkv(lp["attn"], apply_norm(lp["ln1"], x, cfg.norm), cfg)
        q, k = _rope_qk(q, k, cfg, positions)
        k_all, v_all = cache["k"][layer], cache["v"][layer]
        if paged:
            tables = cache["tables"]
            write_paged(k_all, tables, positions, k)
            write_paged(v_all, tables, positions, v)
            lane_k, lane_v = (gather_lane(k_all, tables),
                              gather_lane(v_all, tables))
        else:
            rows = cache["slots"].long()
            k_all[rows[:, None], :, positions.long()] = k
            v_all[rows[:, None], :, positions.long()] = v
            lane_k, lane_v = k_all[rows], v_all[rows]
        out = prefill_attention(q, lane_k, lane_v, pos0, kv_len,
                                window=cfg.sliding_window)
        x, _ = _ffn_residual(lp, x + _attn_proj(lp, out), cfg, per_row=True)
    return _final(params, cfg, x), {**cache, "pos": kv_len}


def decode_step(params: Params, cfg: ModelConfig, cache: Cache,
                token: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token: (B, 1) int at per-row positions ``pos``.

    Per layer the token's K/V row is written first: paged, into block
    ``tables[b, (pos % W) // bs]``, before the paged decode kernel attends
    ``min(pos+1, W)`` rows; contiguous, into lane slot ``pos % W``, before
    the ring decode kernel attends the lane under the ring and window mask.
    A wrap past W overwrites the oldest row: the reference's ring
    semantics. HYBRID's SSM advances its conv tail and state by one token,
    as the SSM family advances its state and token shifts. The
    encoder-decoder family then attends its slot's cross lanes, every
    encoder row visible (the ring decode kernel at ``pos = F - 1`` over an
    F-row lane: no row masked, none written). M-RoPE takes ``pos`` in all
    three streams; learned positions add table row ``pos mod 8192``. Each
    row's token is its own MoE dispatch, as under the reference engine's
    ``vmap``. Returns ``(logits (B, V), cache)`` with ``pos`` advanced by
    one."""
    check_supported(cfg)
    pos = cache["pos"].to(torch.int32)
    x = _embed(params, cfg, token, pos)
    positions = pos[:, None]
    paged = "tables" in cache
    if paged:
        tables = cache["tables"]
        lengths = torch.clamp(pos + 1, max=tables.shape[1]
                              * cache["k"].shape[2])
    else:
        slots = cache["slots"].to(torch.int32)
        rows = slots
    if "cross_k" in cache:      # every encoder row visible
        cross_pos = torch.full_like(pos, cache["cross_k"].shape[3] - 1)
    for layer, lp in enumerate(map(gather_fsdp, unstack_layers(params))):
        xn = apply_norm(lp["ln1"], x, cfg.norm)
        if cfg.family == SSM:
            x = _rwkv_step(lp, x, xn, cfg, cache, layer, rows)
            continue
        q, k, v = _qkv(lp["attn"], xn, cfg)
        q, k = _rope_qk(q, k, cfg, positions)
        k_all, v_all = cache["k"][layer], cache["v"][layer]
        if paged:
            write_paged(k_all, tables, positions, k)
            write_paged(v_all, tables, positions, v)
            out = paged_decode_attention(q[:, 0], k_all, v_all, tables,
                                         lengths)
        else:
            sharded.write_token(k_all, slots, k[:, 0], pos)
            sharded.write_token(v_all, slots, v[:, 0], pos)
            out = sharded.ring_decode(q[:, 0], k_all, v_all, slots, pos,
                                      window=cfg.sliding_window)
        mix = _attn_proj(lp, out[:, None])
        if cfg.family == HYBRID:
            tails = cache["conv_tail"][layer]
            states = cache["ssm_state"][layer]
            ssm_out, tail, state = ssd.ssm_step(
                lp["ssm"], xn[:, 0], cfg, sharded.take_rows(tails, rows),
                sharded.take_rows(states, rows))
            sharded.put_rows(tails, rows, tail)
            sharded.put_rows(states, rows, state)
            mix = 0.5 * (mix + _residual(ssm_out[:, None]))
        x = x + mix
        if "cross_k" in cache:
            q = _q(lp["cross"], apply_norm(lp["ln_cross"], x, cfg.norm), cfg)
            out = sharded.ring_decode(q[:, 0], cache["cross_k"][layer],
                                      cache["cross_v"][layer], slots,
                                      cross_pos)
            x = x + _attn_proj(lp, out[:, None], "cross")
        x, _ = _ffn_residual(lp, x, cfg, per_row=True)
    return _final(params, cfg, x)[:, 0], {**cache, "pos": pos + 1}
