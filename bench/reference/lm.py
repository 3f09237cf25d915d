"""Plain reference of the served language models, in float32 with TF32 off.

Written from the published descriptions, as the benchmark's configuration
files state them (their ``assumed`` lists every departure from the paper):

* Decoder layers: pre-norm RMSNorm (eps 1e-5), rotary positions on the two
  halves of each head (theta from the config), grouped-query attention
  (query head h reads key/value head ``h // (H / KH)``), causal, within
  ``sliding_window`` positions where one is set; a SwiGLU MLP.
* MoE (OLMoE, arXiv:2409.02060): a softmax router over E experts, the top k
  (ties to the lower index) with their gates renormalised over the k, each
  expert a SwiGLU MLP. The configuration bounds each expert's capacity:
  the tokens of a dispatch are cut into groups of ``min(group_size,
  tokens)`` consecutive tokens; in a group an expert takes at most ``C =
  max(8, ceil8(floor(group * k * capacity_factor / E)))`` slots, counted
  slot-major (every token's first choice in token order, then every
  token's second, ...); a slot past C is dropped with its gate.
* Hybrid (Hymba, arXiv:2411.13676): attention and a Mamba-2/SSD head bank
  read the same normed input and their outputs are averaged. The SSD bank:
  ``x | z = x W_in``; a causal depthwise conv of width K over x, then SiLU;
  ``B | C = x W_bc`` shared by the heads; ``dt = softplus(x W_dt + b)``;
  per-head decay ``a = exp(clamp(-exp(A_log) dt, -1, -1e-6))``;
  ``S_t = a_t S_{t-1} + B_t (dt_t x_t)^T``, ``y_t = C_t S_t``;
  ``out = (y * silu(z)) W_out``.

Which tokens share an MoE dispatch is the serving schedule's, not the
model's, so the caller names it: a *group* of rows whose first ``S1``
tokens were dispatched together (a prompt's first chunk beside the other
prompts of its step), and, for the one row judged, the segments of its
later tokens (a continuation chunk is a dispatch of its own, a decoded
token is a dispatch of one). Weights are read as they are stored and
upcast per layer; nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.reference.precision import F32, mm

Segment = Tuple[int, int, str]       # (start, end, "chunk" | "token")


def _rms(x, scale, eps=1e-5):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x, positions, theta):
    """x (..., S, H, dh) f32; positions (S,)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                         dtype=torch.float32) / dh)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attend(q, k, v, pos_q, pos_k, window, precision):
    """q (B, Sq, H, dh), k/v (B, Sk, KH, dh) -> (B, Sq, H*dh)."""
    b, sq, h, dh = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)        # (B, H, Sk, dh)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    s = mm(q.transpose(1, 2), k.transpose(-1, -2), precision) / math.sqrt(dh)
    ok = pos_k[None, :] <= pos_q[:, None]
    if window:
        ok = ok & (pos_q[:, None] - pos_k[None, :] < window)
    s = s.masked_fill(~ok, float("-inf"))
    out = mm(torch.softmax(s, -1), v, precision)             # (B, H, Sq, dh)
    return out.transpose(1, 2).reshape(b, sq, h * dh)


def _swiglu(x, w_up, w_gate, w_down, precision):
    return mm(F.silu(mm(x, w_gate.float(), precision))
              * mm(x, w_up.float(), precision), w_down.float(), precision)


def _capacity(tg: int, moe: dict) -> int:
    c = int(tg * moe["top_k"] * moe["capacity_factor"] / moe["num_experts"])
    return max(8, -(-c // 8) * 8)


def moe_dispatch(x, p, layer: int, moe: dict, tg: int, precision,
                 margins=None):
    """One dispatch of tokens ``x`` (M, d), groups of ``tg``. ``margins``,
    a list, gets each token's router margin: the k-th largest probability
    less the next (how near its choice of experts was to a tie)."""
    m, d = x.shape
    e, k = moe["num_experts"], moe["top_k"]
    g = m // tg
    cap = _capacity(tg, moe)
    xg = x.view(g, tg, d)
    probs = torch.softmax(mm(xg, p["router"][layer].float(), precision), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:
        margins.append((vals[..., k - 1] - vals[..., k]).reshape(-1))
    vals, idx = vals[..., :k], idx[..., :k]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    expert = idx.transpose(1, 2).reshape(g, k * tg)          # slot-major
    onehot = F.one_hot(expert, e)
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)
    keep = (pos < cap).reshape(-1)
    expert = expert.reshape(-1)
    token = (torch.arange(g, device=x.device)[:, None] * tg
             + torch.arange(tg, device=x.device).repeat(k)[None]).reshape(-1)
    gate = vals.transpose(1, 2).reshape(-1)
    y = torch.zeros_like(x)
    for ex in torch.unique(expert[keep]).tolist():
        sel = keep & (expert == ex)
        t = token[sel]
        out = _swiglu(x[t], p["w_up"][layer, ex], p["w_gate"][layer, ex],
                      p["w_down"][layer, ex], precision)
        y.index_add_(0, t, out * gate[sel][:, None])
    return y


def _ssm(x, p, layer: int, ssm: dict, precision, chunk: int = 64):
    """SSD heads over x (B, T, d) from a zero state -> (B, T, d)."""
    b, t, _ = x.shape
    n, hd, kw = ssm["state_size"], ssm["head_dim"], ssm["conv_width"]
    xz = mm(x, p["w_in"][layer].float(), precision)
    di = xz.shape[-1] // 2
    nh = di // hd
    xi, z = xz[..., :di], xz[..., di:]
    w = p["conv"][layer].float()                             # (K, Di)
    xp = F.pad(xi, (0, 0, kw - 1, 0))
    xc = F.silu(sum(xp[:, i:i + t] * w[i] for i in range(kw)))
    bc = mm(xc, p["w_bc"][layer].float(), precision)
    bm, cm = bc[..., :n], bc[..., n:]                        # (B, T, N)
    dt = F.softplus(mm(xc, p["w_dt"][layer].float(), precision)
                    + p["dt_bias"][layer].float())           # (B, T, nh)
    ld = torch.clamp(-torch.exp(p["a_log"][layer].float()) * dt, -1.0, -1e-6)
    v = xc.view(b, t, nh, hd) * dt[..., None]                # (B, T, nh, hd)
    state = x.new_zeros(b, nh, n, hd)
    ys = []
    for s0 in range(0, t, chunk):
        s1 = min(s0 + chunk, t)
        c = s1 - s0
        cum = ld[:, s0:s1].cumsum(1).transpose(1, 2)         # (B, nh, c)
        diff = cum[..., :, None] - cum[..., None, :]         # t - s
        tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~tri, float("-inf")))
        cb = mm(cm[:, s0:s1], bm[:, s0:s1].transpose(1, 2), precision)
        vv = v[:, s0:s1].transpose(1, 2)                     # (B, nh, c, hd)
        y = mm(decay * cb[:, None], vv, precision)
        y = y + torch.exp(cum)[..., None] * mm(cm[:, None, s0:s1], state,
                                               precision)
        ys.append(y.transpose(1, 2))                         # (B, c, nh, hd)
        tail = torch.exp(cum[..., -1:] - cum)                # (B, nh, c)
        state = torch.exp(cum[..., -1])[..., None, None] * state + mm(
            (bm[:, None, s0:s1] * tail[..., None]).transpose(-1, -2), vv,
            precision)
    y = torch.cat(ys, 1).reshape(b, t, di)
    return mm(y * F.silu(z), p["w_out"][layer].float(), precision)


@torch.no_grad()
def logits(params: dict, cfg: dict, group: torch.Tensor, row: int,
           own: torch.Tensor, segments: Sequence[Segment],
           positions: Sequence[int], precision: str = F32,
           probe: dict = None) -> torch.Tensor:
    """Float32 logits (len(positions), V) of row ``row`` of ``group``.

    ``group`` (lanes, S1): tokens dispatched together from position 0;
    ``own`` (R,): the row's tokens at positions S1 .. S1 + R - 1, whose
    MoE dispatches ``segments`` name (offsets into ``own``); ``positions``:
    the absolute positions whose logits are wanted. ``probe``, a dict,
    gets ``"margin"``: each wanted position's smallest router margin over
    the layers (MoE only)."""
    lay = params["layers"]
    lanes, s1 = group.shape
    r = own.shape[0]
    dev = group.device
    window = cfg.get("sliding_window")
    theta = cfg["rope_theta"]
    h, kh, dh = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    moe, ssm = cfg.get("moe"), cfg.get("ssm")
    embed = params["embed"]
    xg = embed[group].float()
    xo = embed[own].float()
    pos_g = torch.arange(s1, device=dev)
    pos_o = torch.arange(s1, s1 + r, device=dev)
    if ssm is not None and r:
        raise ValueError("the hybrid reference takes a row as one group")
    for i in range(cfg["num_layers"]):
        a = {k: v[i].float() for k, v in lay["attn"].items()}
        ng = _rms(xg, lay["ln1"]["scale"][i])
        no = _rms(xo, lay["ln1"]["scale"][i])

        def qkv(x, pos):
            q = _rope(mm(x, a["wq"], precision).unflatten(-1, (h, dh)), pos,
                      theta)
            k = _rope(mm(x, a["wk"], precision).unflatten(-1, (kh, dh)), pos,
                      theta)
            return q, k, mm(x, a["wv"], precision).unflatten(-1, (kh, dh))
        qg, kg, vg = qkv(ng, pos_g)
        mix_g = mm(_attend(qg, kg, vg, pos_g, pos_g, window, precision),
                   a["wo"], precision)
        if ssm is not None:
            mix_g = 0.5 * (mix_g + _ssm(ng, lay["ssm"], i, ssm, precision))
        xg = xg + mix_g
        if r:
            qo, ko, vo = qkv(no[None], pos_o)
            k_all = torch.cat([kg[row:row + 1], ko], 1)
            v_all = torch.cat([vg[row:row + 1], vo], 1)
            pos_k = torch.arange(s1 + r, device=dev)
            xo = xo + mm(_attend(qo, k_all, v_all, pos_o, pos_k, window,
                                 precision), a["wo"], precision)[0]
        ng = _rms(xg, lay["ln2"]["scale"][i])
        no = _rms(xo, lay["ln2"]["scale"][i])
        yg = torch.zeros_like(xg)
        yo = torch.zeros_like(xo)
        if moe is not None:
            mg = [] if probe is not None else None
            flat = ng.reshape(-1, ng.shape[-1])
            yg = yg + moe_dispatch(flat, lay["moe"], i, moe,
                                   min(moe["group_size"], flat.shape[0]),
                                   precision, mg).view_as(xg)
            for s, e, kind in segments:
                tg = 1 if kind == "token" else min(moe["group_size"], e - s)
                yo[s:e] += moe_dispatch(no[s:e], lay["moe"], i, moe, tg,
                                        precision, mg)
            if mg is not None:
                m = torch.cat([mg[0].view(lanes, s1)[row], *mg[1:]])
                probe["margin"] = m if "margin" not in probe else \
                    torch.minimum(probe["margin"], m)
        if "mlp" in lay:
            mp = {k: v[i] for k, v in lay["mlp"].items()}
            yg = yg + _swiglu(ng, mp["w_up"], mp["w_gate"], mp["w_down"],
                              precision)
            if r:
                yo = yo + _swiglu(no, mp["w_up"], mp["w_gate"],
                                  mp["w_down"], precision)
        xg, xo = xg + yg, xo + yo
    rows: List[torch.Tensor] = [xg[row, p] if p < s1 else xo[p - s1]
                                for p in positions]
    if probe is not None and "margin" in probe:
        probe["margin"] = probe["margin"][list(positions)]
    x = _rms(torch.stack(rows), params["final_norm"]["scale"])
    return mm(x, params["lm_head"].float(), precision)
