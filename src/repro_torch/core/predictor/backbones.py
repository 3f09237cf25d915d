"""Transformer backbones of the ranking predictor: BERT / OPT / T5 heads.

Port of ``repro/core/predictor/backbones.py`` (inference). The method is the
reference's: encode prompt -> pooled feature -> linear scalar score.

* ``bert`` - bidirectional encoder; feature = tanh(W h[CLS]) (BERT pooler).
* ``opt``  - causal decoder; feature = hidden of the last non-pad token.
* ``t5``   - encoder + one-query attention-pooling readout.

The predictor's attention is plain PyTorch (``attention_naive``), as the
reference's is XLA and not a kernel. Parameters keep the reference's layout
with layer leaves stacked on a leading axis; the layer loop is Python.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.predictor.tokenizer import PAD
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import attention_naive
from repro_torch.models.common import dense_init, embed_init

Params = Dict[str, Any]

BACKBONES = ("bert", "opt", "t5")


@dataclass(frozen=True)
class PredictorConfig:
    """Defaults sized for the 1-core CPU container (DESIGN.md §8): the paper
    uses BERT-base (110M); the method is scale-free, so the repro default is a
    ~0.4M-param mini. Pass a larger config on real hardware."""
    backbone: str = "bert"
    vocab_size: int = 2048
    max_len: int = 32
    d_model: int = 64
    num_heads: int = 2
    num_layers: int = 2
    d_ff: int = 192


def init_predictor(cfg: PredictorConfig, seed: int = 0, *,
                   device: DeviceLike = "cuda") -> Params:
    """Random f32 predictor parameters drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (the reference's distributions,
    not its bits)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, f, n = cfg.d_model, cfg.d_ff, cfg.num_layers

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    p: Params = {
        "embed": embed_init(gen, (cfg.vocab_size, d)),
        "pos": embed_init(gen, (cfg.max_len, d)),
        "layers": {
            "wq": dense_init(gen, (n, d, d), in_axis_size=d),
            "wk": dense_init(gen, (n, d, d), in_axis_size=d),
            "wv": dense_init(gen, (n, d, d), in_axis_size=d),
            "wo": dense_init(gen, (n, d, d), in_axis_size=d),
            "w1": dense_init(gen, (n, d, f), in_axis_size=d),
            "w2": dense_init(gen, (n, f, d), in_axis_size=f),
            "ln1": ones(n, d), "ln1b": zeros(n, d),
            "ln2": ones(n, d), "ln2b": zeros(n, d),
        },
        "ln_f": ones(d), "ln_fb": zeros(d),
        "head": dense_init(gen, (d, 1)),
    }
    if cfg.backbone == "bert":
        p["pooler"] = dense_init(gen, (d, d))
    if cfg.backbone == "t5":
        p["pool_query"] = embed_init(gen, (1, d))
    return p


def _ln(x: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + 1e-5) * scale + bias).to(x.dtype)


def predictor_forward(params: Params, cfg: PredictorConfig,
                      tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, T) int -> scores (B,) f32. Higher = longer expected
    output."""
    b, t = tokens.shape
    h = cfg.num_heads
    dh = cfg.d_model // h
    pad_mask = tokens != PAD
    x = params["embed"][tokens] + params["pos"][None, :t]
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, t)
    pos_kv = torch.where(pad_mask, positions, -1)      # PAD slots masked out
    causal = cfg.backbone == "opt"
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in layers.items()}
        xn = _ln(x, lp["ln1"], lp["ln1b"])
        q = (xn @ lp["wq"]).reshape(b, t, h, dh)
        k = (xn @ lp["wk"]).reshape(b, t, h, dh)
        v = (xn @ lp["wv"]).reshape(b, t, h, dh)
        att = attention_naive(q, k, v, positions, pos_kv, causal=causal)
        x = x + att.reshape(b, t, cfg.d_model) @ lp["wo"]
        xn = _ln(x, lp["ln2"], lp["ln2b"])
        x = x + F.gelu(xn @ lp["w1"], approximate="tanh") @ lp["w2"]
    x = _ln(x, params["ln_f"], params["ln_fb"])

    if cfg.backbone == "bert":
        feat = torch.tanh(x[:, 0] @ params["pooler"])        # [CLS] pooler
    elif cfg.backbone == "opt":
        last = torch.clamp(pad_mask.sum(-1) - 1, min=0)      # last real token
        feat = x[torch.arange(b, device=x.device), last]
    else:  # t5: one-query attention pooling over encoder states
        q = params["pool_query"][None].expand(b, 1, cfg.d_model)
        scores = torch.einsum("bqd,btd->bqt", q, x) / cfg.d_model ** 0.5
        scores = torch.where(pad_mask[:, None], scores,
                             torch.full_like(scores, -1e30))
        feat = torch.einsum("bqt,btd->bqd", torch.softmax(scores, -1), x)[:, 0]
    return (feat @ params["head"])[:, 0].float()
