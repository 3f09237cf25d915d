"""Plain reference of DeepSeek-V3-style decoders (Moonlight-16B-A3B), in
float32 with TF32 off.

Written from the published descriptions, as the benchmark's configuration
file states them (its ``assumed`` lists every departure):

* Layers: pre-norm RMSNorm (eps 1e-5). The first ``first_k_dense`` layers
  hold a dense SwiGLU MLP of ``dense_d_ff``; the rest a mixture of experts
  beside shared experts (one SwiGLU of ``d_ff``), the two outputs summed.
* Multi-head latent attention (arXiv:2405.04434 §2.1) without a query
  low-rank path, in its published, non-absorbed form: per head ``q = x
  W_q`` split into a nope part (``qk_nope_head_dim``) and a rope part
  (``qk_rope_head_dim``); ``[c | k_pe] = x W_kva``, ``c`` RMS-normed (its
  own scale); ``[k_nope | v] = c W_kvb`` per head; rotary positions on the
  two halves of q's rope part and of ``k_pe`` (one head shared by all);
  causal attention of ``[q_nope | q_pe]`` over ``[k_nope | k_pe]`` with
  scale ``1/sqrt(nope + rope)``, weighting v.
* The router (arXiv:2412.19437 §2.1.2, one group): sigmoid scores of the
  ``E`` experts; the top k of the scores plus the per-expert bias (ties to
  the lower index) are chosen; each chosen expert's gate is its score,
  normalised over the k, times ``routed_scaling_factor``. Each expert a SwiGLU MLP. Expert capacity as
  ``bench/reference/lm.py`` bounds it (groups of ``min(group_size,
  tokens)``, ``C = max(8, ceil8(floor(group * k * capacity_factor / E)))``
  slots, counted slot-major, a slot past C dropped with its gate).

Which tokens share an MoE dispatch is the serving schedule's: the caller
names it, as for ``bench/reference/lm.py``. Weights are read as they are
stored and upcast per layer; nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from bench.reference.lm import Segment, _capacity, _rms, _rope, _swiglu
from bench.reference.precision import F32, mm


def _qkv(a: dict, x, pos, cfg: dict, precision):
    """x (B, S, d) f32 normed -> q, k (B, S, H, nope + rope), v (B, S, H,
    v_head_dim)."""
    h, dn, dr = cfg["num_heads"], cfg["qk_nope_head_dim"], \
        cfg["qk_rope_head_dim"]
    r, dv, theta = cfg["kv_lora_rank"], cfg["v_head_dim"], cfg["rope_theta"]
    q = mm(x, a["wq"], precision).unflatten(-1, (h, dn + dr))
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, theta)], -1)
    kv = mm(x, a["wkv_a"], precision)
    c = _rms(kv[..., :r], a["kv_norm"])
    k_pe = _rope(kv[..., None, r:], pos, theta)              # (B, S, 1, dr)
    kvb = mm(c, a["wkv_b"], precision).unflatten(-1, (h, dn + dv))
    k = torch.cat([kvb[..., :dn], k_pe.expand(*k_pe.shape[:2], h, dr)], -1)
    return q, k, kvb[..., dn:]


def _attend(q, k, v, pos_q, pos_k, precision):
    """q, k (B, S, H, dqk), v (B, Sk, H, dv) -> (B, Sq, H*dv), causal."""
    b, sq, h, dqk = q.shape
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), precision) \
        / math.sqrt(dqk)
    ok = pos_k[None, :] <= pos_q[:, None]
    s = s.masked_fill(~ok, float("-inf"))
    out = mm(torch.softmax(s, -1), v.transpose(1, 2), precision)
    return out.transpose(1, 2).reshape(b, sq, -1)


def moe_dispatch(x, p, layer: int, cfg: dict, tg: int, precision,
                 margins=None):
    """One dispatch of tokens ``x`` (M, d), groups of ``tg``, through the
    sigmoid router. ``margins``, a list, gets each token's k-th largest
    choice score (score plus bias) less the next."""
    moe = cfg["moe"]
    m, d = x.shape
    e, k = moe["num_experts"], moe["top_k"]
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
    keep = (pos < cap).reshape(-1)
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


def _layer(params: dict, i: int, cfg: dict):
    """Layer ``i``'s tree and its index in that tree's stack."""
    k = cfg["first_k_dense"]
    return (params["dense_layers"], i) if i < k else \
        (params["layers"], i - k)


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
    moe = cfg["moe"]
    embed = params["embed"]
    xg = embed[group].float()
    xo = embed[own].float()
    pos_g = torch.arange(s1, device=dev)
    pos_o = torch.arange(s1, s1 + r, device=dev)
    pos_k = torch.arange(s1 + r, device=dev)
    for i in range(cfg["num_layers"]):
        lay, j = _layer(params, i, cfg)
        at = lay["attn"]
        a = {"wq": at["wq"][j].float(), "wkv_a": at["wkv_a"][j].float(),
             "kv_norm": at["kv_norm"]["scale"][j], "wkv_b": at["wkv_b"][j]
             .float()}
        wo = at["wo"][j].float()
        ng = _rms(xg, lay["ln1"]["scale"][j])
        qg, kg, vg = _qkv(a, ng, pos_g, cfg, precision)
        xg = xg + mm(_attend(qg, kg, vg, pos_g, pos_g, precision), wo,
                     precision)
        if r:
            no = _rms(xo, lay["ln1"]["scale"][j])
            qo, ko, vo = _qkv(a, no[None], pos_o, cfg, precision)
            k_all = torch.cat([kg[row:row + 1], ko], 1)
            v_all = torch.cat([vg[row:row + 1], vo], 1)
            xo = xo + mm(_attend(qo, k_all, v_all, pos_o, pos_k, precision),
                         wo, precision)[0]
        ng = _rms(xg, lay["ln2"]["scale"][j])
        no = _rms(xo, lay["ln2"]["scale"][j])
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
    x = _rms(torch.stack(rows), params["final_norm"]["scale"])
    return mm(x, params["lm_head"].float(), precision)
