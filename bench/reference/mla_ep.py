"""Plain reference of one chip's share of an expert-parallel
DeepSeek-V3-style decoder (Kimi-K2-Instruct), in float32 with TF32 off.

Written from the published model (DeepSeek-V3's ``modeling_deepseek.py``,
which Kimi K2's config names), as the benchmark's configuration file
states it, beside ``bench/reference/mla.py`` (Moonlight), whose layer
layout and capacity it shares:

* Layers: pre-norm RMSNorm, eps ``norm_eps`` (1e-6 for Kimi K2), every
  norm. The first ``first_k_dense`` layers hold a dense SwiGLU MLP of
  ``dense_d_ff``; the rest a mixture of experts beside the shared expert
  (one SwiGLU of ``d_ff``), the two outputs summed.
* Multi-head latent attention (arXiv:2405.04434 §2.1) in its published,
  non-absorbed form, with the query low-rank path: ``q = rmsnorm(x
  W_qa) W_qb`` per head split into a nope part (``qk_nope_head_dim``) and a
  rope part (``qk_rope_head_dim``); ``[c | k_pe] = x W_kva``, ``c``
  RMS-normed; ``[k_nope | v] = c W_kvb`` per head; causal attention of
  ``[q_nope | q_pe]`` over ``[k_nope | k_pe]`` weighting v.
* YaRN (DeepSeek-V3's ``DeepseekV3YarnRotaryEmbedding``) on the rope
  parts: ``corr(n) = dr ln(original / (2 pi n)) / (2 ln theta)``, ``low =
  floor(corr(beta_fast))``, ``high = ceil(corr(beta_slow))`` (0.001 apart
  where equal), ``ramp_i = clamp((i - low) / (high - low), 0, 1)``, each
  pair's frequency ``theta^(-2i/dr)`` times ``1 - ramp_i`` plus that over
  ``factor`` times ``ramp_i``; cos and sin times ``mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)``, ``mscale(s, m) = 0.1 m ln s + 1``; the
  softmax scale ``(nope + rope)^-0.5 mscale(factor, mscale_all_dim)^2``.
* The router (arXiv:2412.19437 §2.1.2, one group): sigmoid scores of all
  ``E`` experts; the top k of the scores plus the per-expert bias (ties to
  the lower index) are chosen; each chosen expert's gate is its score,
  normalised over the k, times ``routed_scaling_factor``. Expert capacity
  as ``bench/reference/lm.py`` bounds it, over all E experts. Only the
  first ``experts_held`` experts' outputs are added: this chip's share,
  whose weights are the only ones the tree holds.

Departures from the published model (the configuration's ``assumed``):
capacity drops at 1.25 where the model drops nothing; the selection bias
drawn from the seed; rotate-half rope where the published layout is
interleaved (a fixed permutation of random weights' rope columns); the
other chips' experts, layers and vocabulary rows absent (the cut). Which
tokens share an MoE dispatch is the serving schedule's: the caller names
it, as for ``bench/reference/lm.py``. Weights are read as they are stored
and upcast per layer (the experts one at a time); nothing of the program
is imported.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from bench.reference.lm import Segment, _capacity, _rms, _swiglu
from bench.reference.mla import _layer
from bench.reference.precision import F32, mm


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_freqs(cfg: dict, device) -> torch.Tensor:
    """The rope's frequencies (dr/2,) under YaRN (plain where
    ``rope_factor`` is 1)."""
    dr, theta = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    base = 1.0 / theta ** (torch.arange(0, dr, 2, device=device,
                                        dtype=torch.float32) / dr)
    factor = cfg.get("rope_factor", 1.0)
    if factor <= 1:
        return base

    def corr(n):
        return dr * math.log(cfg["rope_original_max"] / (n * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(corr(cfg["rope_beta_fast"])), 0)
    high = min(math.ceil(corr(cfg["rope_beta_slow"])), dr - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dr // 2, device=device, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    return base * (1 - ramp) + base / factor * ramp


def rope_scale(cfg: dict) -> float:
    f = cfg.get("rope_factor", 1.0)
    return _mscale(f, cfg.get("rope_mscale", 1.0)) / _mscale(
        f, cfg.get("rope_mscale_all_dim", 0.0))


def softmax_scale(cfg: dict) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    m = cfg.get("rope_mscale_all_dim", 0.0)
    return s * _mscale(cfg.get("rope_factor", 1.0), m) ** 2 if m else s


def _rope(x, positions, cfg: dict):
    """x (..., S, H, dr) f32; positions (S,)."""
    half = x.shape[-1] // 2
    ang = positions.float()[:, None] * yarn_freqs(cfg, x.device)
    m = rope_scale(cfg)
    cos, sin = torch.cos(ang)[:, None] * m, torch.sin(ang)[:, None] * m
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _qkv(a: dict, x, pos, cfg: dict, precision):
    """x (B, S, d) f32 normed -> q, k (B, S, H, nope + rope), v (B, S, H,
    v_head_dim)."""
    h, dn, dr = cfg["num_heads"], cfg["qk_nope_head_dim"], \
        cfg["qk_rope_head_dim"]
    r, dv, eps = cfg["kv_lora_rank"], cfg["v_head_dim"], cfg["norm_eps"]
    cq = _rms(mm(x, a["wq_a"], precision), a["q_norm"], eps)
    q = mm(cq, a["wq_b"], precision).unflatten(-1, (h, dn + dr))
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, cfg)], -1)
    kv = mm(x, a["wkv_a"], precision)
    c = _rms(kv[..., :r], a["kv_norm"], eps)
    k_pe = _rope(kv[..., None, r:], pos, cfg)                # (B, S, 1, dr)
    kvb = mm(c, a["wkv_b"], precision).unflatten(-1, (h, dn + dv))
    k = torch.cat([kvb[..., :dn], k_pe.expand(*k_pe.shape[:2], h, dr)], -1)
    return q, k, kvb[..., dn:]


def _attend(q, k, v, pos_q, pos_k, scale: float, precision):
    """q, k (B, S, H, dqk), v (B, Sk, H, dv) -> (B, Sq, H*dv), causal."""
    b, sq = q.shape[:2]
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), precision) * scale
    ok = pos_k[None, :] <= pos_q[:, None]
    s = s.masked_fill(~ok, float("-inf"))
    out = mm(torch.softmax(s, -1), v.transpose(1, 2), precision)
    return out.transpose(1, 2).reshape(b, sq, -1)


def moe_dispatch(x, p, layer: int, cfg: dict, tg: int, precision,
                 margins=None):
    """One dispatch of tokens ``x`` (M, d), groups of ``tg``, through the
    sigmoid router over all E experts; the held experts' part alone.
    ``margins``, a list, gets each token's k-th largest choice score
    (score plus bias) less the next."""
    moe = cfg["moe"]
    m, d = x.shape
    e, k = moe["num_experts"], moe["top_k"]
    held = cfg.get("experts_held") or e
    g = m // tg
    cap = _capacity(tg, moe)
    xg = x.view(g, tg, d)
    scores = torch.sigmoid(mm(xg, p["router"][layer].float(), precision))
    choice = scores + p["router_bias"][layer].float()
    vals, idx = torch.sort(choice, dim=-1, descending=True, stable=True)
    if margins is not None:
        margins.append((vals[..., k - 1] - vals[..., k]).reshape(-1))
    idx = idx[..., :k]
    gates = scores.gather(-1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    gates = gates * cfg["routed_scaling_factor"]
    expert = idx.transpose(1, 2).reshape(g, k * tg)          # slot-major
    onehot = F.one_hot(expert, e)
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)
    keep = ((pos < cap) & (expert < held)).reshape(-1)
    expert = expert.reshape(-1)
    token = (torch.arange(g, device=x.device)[:, None] * tg
             + torch.arange(tg, device=x.device).repeat(k)[None]).reshape(-1)
    gate = gates.transpose(1, 2).reshape(-1)
    y = torch.zeros_like(x)
    for ex in torch.unique(expert[keep]).tolist():
        sel = keep & (expert == ex)
        t = token[sel]
        out = _swiglu(x[t], p["w_up"][layer, ex], p["w_gate"][layer, ex],
                      p["w_down"][layer, ex], precision)
        y.index_add_(0, t, out * gate[sel][:, None])
    return y


@torch.no_grad()
def logits(params: dict, cfg: dict, group: torch.Tensor, row: int,
           own: torch.Tensor, segments: Sequence[Segment],
           positions: Sequence[int], precision: str = F32,
           probe: dict = None) -> torch.Tensor:
    """Float32 logits (len(positions), V) of row ``row`` of ``group``, with
    ``group``, ``own``, ``segments``, ``positions`` and ``probe`` as
    ``bench/reference/lm.py``'s ``logits`` takes them."""
    lanes, s1 = group.shape
    r = own.shape[0]
    dev = group.device
    moe, eps = cfg["moe"], cfg["norm_eps"]
    scale = softmax_scale(cfg)
    embed = params["embed"]
    xg = embed[group].float()
    xo = embed[own].float()
    pos_g = torch.arange(s1, device=dev)
    pos_o = torch.arange(s1, s1 + r, device=dev)
    pos_k = torch.arange(s1 + r, device=dev)
    for i in range(cfg["num_layers"]):
        lay, j = _layer(params, i, cfg)
        at = lay["attn"]
        a = {"wq_a": at["wq_a"][j].float(), "q_norm": at["q_norm"]["scale"][j],
             "wq_b": at["wq_b"][j].float(), "wkv_a": at["wkv_a"][j].float(),
             "kv_norm": at["kv_norm"]["scale"][j],
             "wkv_b": at["wkv_b"][j].float()}
        wo = at["wo"][j].float()
        ng = _rms(xg, lay["ln1"]["scale"][j], eps)
        qg, kg, vg = _qkv(a, ng, pos_g, cfg, precision)
        xg = xg + mm(_attend(qg, kg, vg, pos_g, pos_g, scale, precision), wo,
                     precision)
        if r:
            no = _rms(xo, lay["ln1"]["scale"][j], eps)
            qo, ko, vo = _qkv(a, no[None], pos_o, cfg, precision)
            k_all = torch.cat([kg[row:row + 1], ko], 1)
            v_all = torch.cat([vg[row:row + 1], vo], 1)
            xo = xo + mm(_attend(qo, k_all, v_all, pos_o, pos_k, scale,
                                 precision), wo, precision)[0]
        del a, wo, qg, kg, vg
        ng = _rms(xg, lay["ln2"]["scale"][j], eps)
        no = _rms(xo, lay["ln2"]["scale"][j], eps)
        mp = {k: v[j] for k, v in lay["mlp"].items()}
        yg = _swiglu(ng, mp["w_up"], mp["w_gate"], mp["w_down"], precision)
        yo = _swiglu(no, mp["w_up"], mp["w_gate"], mp["w_down"], precision)
        if i >= cfg["first_k_dense"]:
            mg = [] if probe is not None else None
            flat = ng.reshape(-1, ng.shape[-1])
            yg = yg + moe_dispatch(flat, lay["moe"], j, cfg,
                                   min(moe["group_size"], flat.shape[0]),
                                   precision, mg).view_as(xg)
            for s, e, kind in segments:
                tg = 1 if kind == "token" else min(moe["group_size"], e - s)
                yo[s:e] += moe_dispatch(no[s:e], lay["moe"], j, cfg, tg,
                                        precision, mg)
            if mg is not None:
                m = torch.cat([mg[0].view(lanes, s1)[row], *mg[1:]])
                probe["margin"] = m if "margin" not in probe else \
                    torch.minimum(probe["margin"], m)
        xg, xo = xg + yg, xo + yo
    rows: List[torch.Tensor] = [xg[row, p] if p < s1 else xo[p - s1]
                                for p in positions]
    if probe is not None and "margin" in probe:
        probe["margin"] = probe["margin"][list(positions)]
    x = _rms(torch.stack(rows), params["final_norm"]["scale"], eps)
    return mm(x, params["lm_head"].float(), precision)
