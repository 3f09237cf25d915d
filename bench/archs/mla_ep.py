"""One chip's share of an expert-parallel DeepSeek-V3-style decoder
(Kimi-K2-Instruct): ``mla``'s block with a query low-rank path, YaRN, a
configurable RMSNorm epsilon, and the MoE layers holding the first
``experts_held`` of ``moe.num_experts`` routed experts (the router and its
selection bias keep all of them).

The weights follow ``bench/archs/mla.py``'s conventions in the program's
tree (``dense_layers`` then ``layers``): normal at fan-in scale for
products, 0.02 for the embedding, ones for norm scales (the query path's
too), the router f32, and the router's selection bias f32, normal with std
``BIAS_STD``; the attention's query leaves are ``wq_a``, ``q_norm`` and
``wq_b`` in place of ``wq``, the experts' leaves hold the held experts.

Work counts are of this chip's share of the published math:

* a token's useful FLOPs: 2 per active matmul parameter (the query path's
  two products, MLA's other three, the dense MLP or the router over all E,
  ``top_k x held / E`` routed experts, the expected share of a token's k
  that lands here, and the shared expert, the output head over this chip's
  vocabulary rows) plus, per layer and attended position, the
  non-absorbed scores and values, ``2 H (nope + rope + v)``;
* one decode step's attention and one prefill dispatch's: ``mla``'s
  (:func:`decode_bound_s`, :func:`prefill_bound_s`), which read the heads,
  the latent and the layers from the model dict.
"""
import math

import numpy as np
import torch

from bench.harness import spec
from bench.harness.weights import _normal
from bench.reference import mla_ep

MLA = spec.arch("mla")
BIAS_STD = MLA.BIAS_STD


def program_config(cfg_json: dict):
    return MLA.program_config(cfg_json)


def make_params(cfg, seed: int, device) -> dict:
    """Parameters of ``cfg`` (the program's ``LatentConfig``) from
    ``seed``, on ``device``, drawn in the served dtype."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr = cfg.q_lora_rank
    e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff
    held = cfg.experts_held or e

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
                  "attn": {"wq_a": dense(d, qr, fan_in=d),
                           "q_norm": {"scale": ones(qr)},
                           "wq_b": dense(qr, h * (dn + dr), fan_in=qr),
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
                "w_up": dense(held, d, fe, fan_in=d),
                "w_gate": dense(held, d, fe, fan_in=d),
                "w_down": dense(held, fe, d, fan_in=fe)}
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
    return mla_ep.logits(params, model, group, row, own, segments, positions,
                         precision, probe)


def _attn_params(m: dict) -> int:
    d, h, r, qr = m["d_model"], m["num_heads"], m["kv_lora_rank"], \
        m["q_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    return (d * qr + qr * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
            + h * dv * d)


def matmul_params(m: dict) -> float:
    """Active matmul parameters of one token on this chip, over every layer
    and the output head: a routed expert counts ``held / E`` of the
    ``top_k`` times, the expected share of a token's choices held here."""
    d, e = m["d_model"], m["moe"]
    k = m["first_k_dense"]
    held = m.get("experts_held") or e["num_experts"]
    dense = _attn_params(m) + 3 * d * m["dense_d_ff"]
    sparse = (_attn_params(m) + d * e["num_experts"]
              + e["top_k"] * held / e["num_experts"] * 3 * d
              * e["expert_d_ff"] + 3 * d * m["d_ff"])
    return k * dense + (m["num_layers"] - k) * sparse + d * m["vocab_size"]


def tokens_flops(model: dict, positions) -> float:
    """Useful FLOPs of tokens at ``positions`` (an int array)."""
    positions = np.asarray(positions, np.int64)
    attended = float((positions + 1).sum())
    per_pair = 2.0 * model["num_heads"] * (
        model["qk_nope_head_dim"] + model["qk_rope_head_dim"]
        + model["v_head_dim"])
    return 2.0 * matmul_params(model) * len(positions) \
        + model["num_layers"] * per_pair * attended


def decode_bound_s(model: dict, positions, block: int = 0) -> float:
    return MLA.decode_bound_s(model, positions, block)


def prefill_bound_s(model: dict, chunks) -> float:
    return MLA.prefill_bound_s(model, chunks)
