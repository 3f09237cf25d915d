"""Plain reference of the ranking predictor's BERT-style scorer.

A float32 forward from the description in the PARS paper (arXiv:2510.03243,
§III-A) as the repo sizes it: token and position embeddings, post-norm-free
pre-LN encoder layers (bidirectional attention over non-PAD keys, a GELU
MLP), a final LayerNorm, the BERT pooler ``tanh(W h[CLS])`` and a linear
score. Parameters are the benchmark's tree (``bench/harness/predictor.py``);
nothing of the program is imported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.precision import F32, mm
from bench.reference.tokenizer import PAD, encode_batch


def _ln(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def forward(params: dict, cfg: dict, tokens: torch.Tensor,
            precision: str = F32, onehot: bool = False) -> torch.Tensor:
    """tokens (B, T) int64 -> scores (B,) f32. ``onehot`` reads the
    embedding through a one-hot product, the same values, whose gradient
    (unlike a gather's, summed with atomics on the card) is
    deterministic."""
    p = {k: (v if isinstance(v, dict) else v.float())
         for k, v in params.items()}
    lay = {k: v.float() for k, v in params["layers"].items()}
    b, t = tokens.shape
    h = cfg["num_heads"]
    d = cfg["d_model"]
    dh = d // h
    keep = tokens != PAD
    emb = (F.one_hot(tokens, cfg["vocab_size"]).float() @ p["embed"]
           if onehot else p["embed"][tokens])
    x = emb + p["pos"][:t][None]
    for i in range(cfg["num_layers"]):
        xn = _ln(x, lay["ln1"][i], lay["ln1b"][i])
        q, k, v = (mm(xn, lay[w][i], precision).view(b, t, h, dh)
                   .transpose(1, 2) for w in ("wq", "wk", "wv"))
        s = mm(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
        s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
        att = mm(torch.softmax(s, -1), v, precision)
        x = x + mm(att.transpose(1, 2).reshape(b, t, d), lay["wo"][i],
                   precision)
        xn = _ln(x, lay["ln2"][i], lay["ln2b"][i])
        x = x + mm(F.gelu(mm(xn, lay["w1"][i], precision),
                          approximate="tanh"), lay["w2"][i], precision)
    x = _ln(x, p["ln_f"], p["ln_fb"])
    feat = torch.tanh(mm(x[:, 0], p["pooler"], precision))
    return mm(feat, p["head"], precision)[:, 0]


@torch.no_grad()
def score(params: dict, cfg: dict, prompts, device,
          precision: str = F32, block: int = 1024) -> torch.Tensor:
    """Scores of ``prompts`` (host f32 tensor), tokenized here."""
    toks = encode_batch(prompts, cfg["vocab_size"], cfg["max_len"])
    out = []
    for i in range(0, len(toks), block):
        t = torch.as_tensor(toks[i:i + block], device=device)
        out.append(forward(params, cfg, t, precision).cpu())
    return torch.cat(out)
