"""DeepSeek-V3-style decoders (Moonlight-16B-A3B): multi-head latent
attention in every layer, leading dense layers, then experts behind a
sigmoid router with a selection bias, beside shared experts.

The weights follow ``bench/harness/weights.py``'s conventions in the
program's tree (``dense_layers`` then ``layers``): normal at fan-in scale
for products, 0.02 for the embedding, ones for norm scales, the router f32,
and the router's selection bias f32, normal with std ``BIAS_STD``.

Work counts are of the model's published math, whatever path computes it:

* a token's useful FLOPs: 2 per active matmul parameter (MLA's four
  projections, the dense MLP or the router, the ``top_k`` routed experts
  and the shared experts, the output head) plus, per layer and attended
  position, the non-absorbed scores and values, ``2 H (nope + rope + v)``;
* one decode step's attention (the latent decode kernel, absorbed): each
  row's latent rows read once at ``kv_lora_rank + rope`` bf16 columns, its
  absorbed query (H rows of that width) and its output (H rows of
  ``kv_lora_rank``), ``2 H (2 kv_lora_rank + rope)`` FLOPs a position;
* one prefill dispatch's attention (the prefill kernel's MLA instance,
  non-absorbed): queries and keys of ``nope + rope``, values and outputs of
  ``v``, each read or written once, ``2 H (nope + rope + v)`` FLOPs per
  causal (query, key) pair.

Each least time is the larger of bytes over the HBM rate and operations
over the bf16 peak, summed over the layers.
"""
import math

import numpy as np
import torch

from bench.harness import peaks
from bench.harness.weights import _normal
from bench.reference import mla

BF16 = 2
BIAS_STD = 0.1


def program_config(cfg_json: dict):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.latent import LatentConfig
    fields = dict(cfg_json["model"])
    fields["moe"] = MoEConfig(**fields["moe"])
    return LatentConfig(**fields)


def make_params(cfg, seed: int, device) -> dict:
    """Parameters of ``cfg`` (the program's ``LatentConfig``) from
    ``seed``, on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff

    def stack(n, ffn):
        def dense(*shape, fan_in, dtype=dt):
            return _normal(gen, (n, *shape), 1.0 / math.sqrt(fan_in), dtype,
                           dev)

        def ones(*shape):
            return torch.ones((n, *shape), dtype=dt, device=dev)

        def mlp(f):
            return {"w_up": dense(d, f, fan_in=d),
                    "w_gate": dense(d, f, fan_in=d),
                    "w_down": dense(f, d, fan_in=f)}
        layers = {"ln1": {"scale": ones(d)}, "ln2": {"scale": ones(d)},
                  "attn": {"wq": dense(d, h * (dn + dr), fan_in=d),
                           "wkv_a": dense(d, r + dr, fan_in=d),
                           "kv_norm": {"scale": ones(r)},
                           "wkv_b": dense(r, h * (dn + dv), fan_in=r),
                           "wo": dense(h * dv, d, fan_in=h * dv)}}
        if ffn == "dense":
            layers["mlp"] = mlp(cfg.dense_d_ff)
        else:
            layers["mlp"] = mlp(cfg.d_ff)
            layers["moe"] = {
                "router": dense(d, e, fan_in=d, dtype=torch.float32),
                "router_bias": _normal(gen, (n, e), BIAS_STD, torch.float32,
                                       dev),
                "w_up": dense(e, d, fe, fan_in=d),
                "w_gate": dense(e, d, fe, fan_in=d),
                "w_down": dense(e, fe, d, fan_in=fe)}
        return layers

    k = cfg.first_k_dense
    return {"embed": _normal(gen, (cfg.vocab_size, d), 0.02, dt, dev),
            "final_norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
            "dense_layers": stack(k, "dense"),
            "layers": stack(cfg.num_layers - k, "moe"),
            "lm_head": _normal(gen, (d, cfg.vocab_size), 1.0 / math.sqrt(d),
                               dt, dev)}


def logits(params, model, group, row, own, segments, positions, precision,
           probe=None):
    return mla.logits(params, model, group, row, own, segments, positions,
                      precision, probe)


def _attn_params(m: dict) -> int:
    d, h, r = m["d_model"], m["num_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    return d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d


def matmul_params(m: dict) -> int:
    """Active matmul parameters of one token, over every layer and the
    output head."""
    d, e = m["d_model"], m["moe"]
    k = m["first_k_dense"]
    dense = _attn_params(m) + 3 * d * m["dense_d_ff"]
    sparse = (_attn_params(m) + d * e["num_experts"]
              + e["top_k"] * 3 * d * e["expert_d_ff"] + 3 * d * m["d_ff"])
    return k * dense + (m["num_layers"] - k) * sparse + d * m["vocab_size"]


def _qkv_width(m: dict) -> int:
    return m["qk_nope_head_dim"] + m["qk_rope_head_dim"]


def tokens_flops(model: dict, positions) -> float:
    """Useful FLOPs of tokens at ``positions`` (an int array)."""
    positions = np.asarray(positions, np.int64)
    attended = float((positions + 1).sum())
    per_pair = 2.0 * model["num_heads"] * (_qkv_width(model)
                                           + model["v_head_dim"])
    return 2.0 * matmul_params(model) * len(positions) \
        + model["num_layers"] * per_pair * attended


def decode_bound_s(model: dict, positions, block: int = 0) -> float:
    """Least seconds of one decode step's latent attention over rows at
    ``positions``, every layer (``block``: the pool's block size, whose
    table entries the rows read)."""
    h, r = model["num_heads"], model["kv_lora_rank"]
    kd = r + model["qk_rope_head_dim"]
    lens = [p + 1 for p in positions]
    rows = sum(lens) * kd * BF16
    qo = len(lens) * h * (kd + r) * BF16
    meta = len(lens) * 4 + (sum(-(-n // block) for n in lens) * 4
                            if block else 0)
    flops = 2 * h * (kd + r) * sum(lens)
    return model["num_layers"] * max((rows + qo + meta) / peaks.HBM_BYTES,
                                     flops / peaks.BF16_FLOPS)


def prefill_bound_s(model: dict, chunks) -> float:
    """Least seconds of one prefill dispatch's attention, every layer:
    ``chunks`` holds each row's ``(start, end)``, queries at positions
    ``start .. end - 1`` over keys ``0 .. end - 1``, causal."""
    h, dv, dqk = model["num_heads"], model["v_head_dim"], _qkv_width(model)
    nbytes = flops = 0
    for s, e in chunks:
        pairs = (e * (e + 1) - s * (s + 1)) // 2
        flops += 2 * h * (dqk + dv) * pairs
        nbytes += ((e - s) * h * (dqk + dv) + e * h * (dqk + dv)) * BF16
    return model["num_layers"] * max(nbytes / peaks.HBM_BYTES,
                                     flops / peaks.BF16_FLOPS)
