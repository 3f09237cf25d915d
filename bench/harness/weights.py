"""The LLM's weights, drawn by the benchmark on the device from the seed.

One ``torch.Generator`` on the device, one call per stacked leaf (a leaf
holds every layer), in the dtype the configuration serves (the router and
the SSM's ``dt_bias``/``a_log`` in f32, as the program keeps them). The
layout is the program's parameter tree; the values are the benchmark's, so
the program and the reference read the same tensors and neither made them.
Distributions: normal at fan-in scale for products, 0.02 for the
embedding, ones for norm scales, zeros for ``dt_bias`` and ``a_log``, and
normal over the conv width for the SSM's conv taps.
"""
from __future__ import annotations

import math

import torch


def _normal(gen, shape, std, dtype, device):
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(0.0, std, generator=gen)


def make_params(cfg, seed: int, device) -> dict:
    """Parameters of ``cfg`` (a program ``ModelConfig``) from ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    L, d = cfg.num_layers, cfg.d_model
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(*shape, fan_in, dtype=dt):
        return _normal(gen, (L, *shape), 1.0 / math.sqrt(fan_in), dtype, dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers = {"ln1": {"scale": ones(L, d)}, "ln2": {"scale": ones(L, d)},
              "attn": {"wq": dense(d, h * dh, fan_in=d),
                       "wk": dense(d, kh * dh, fan_in=d),
                       "wv": dense(d, kh * dh, fan_in=d),
                       "wo": dense(h * dh, d, fan_in=h * dh)}}
    if cfg.d_ff:
        f = cfg.d_ff
        layers["mlp"] = {"w_up": dense(d, f, fan_in=d),
                         "w_gate": dense(d, f, fan_in=d),
                         "w_down": dense(f, d, fan_in=f)}
    if cfg.moe is not None:
        e, f = cfg.moe.num_experts, cfg.moe.expert_d_ff
        layers["moe"] = {"router": dense(d, e, fan_in=d, dtype=torch.float32),
                         "w_up": dense(e, d, f, fan_in=d),
                         "w_gate": dense(e, d, f, fan_in=d),
                         "w_down": dense(e, f, d, fan_in=f)}
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.expand * d
        nh = di // s.head_dim
        layers["ssm"] = {
            "w_in": dense(d, 2 * di, fan_in=d),
            "conv": _normal(gen, (L, s.conv_width, di), 1.0 / s.conv_width,
                            dt, dev),
            "w_bc": dense(di, 2 * s.state_size, fan_in=di),
            "w_dt": dense(di, nh, fan_in=di),
            "dt_bias": torch.zeros(L, nh, dtype=torch.float32, device=dev),
            "a_log": torch.zeros(L, nh, dtype=torch.float32, device=dev),
            "w_out": dense(di, d, fan_in=di)}
    return {"embed": _normal(gen, (cfg.vocab_size, d), 0.02, dt, dev),
            "final_norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
            "layers": layers,
            "lm_head": _normal(gen, (d, cfg.vocab_size), 1.0 / math.sqrt(d),
                               dt, dev)}
