"""Multi-pod dry-run: trace every (arch × input-shape × mesh) combination
once on ``meta`` tensors and derive its per-device roofline.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
program for 256 or 512 placeholder host devices; the port's counterpart is
to trace the step once, eagerly, on ``meta`` tensors under DTensor over a
fake process group of as many ranks (``launch/mesh.py``), each parameter,
optimizer moment, batch and cache leaf placed as the reference's specs
place it (``sharding/specs.py``) and the activations as its tags place them
(``sharding/annotate.py``). ``launch/cost.py`` counts what each rank does.
A trace has no compiler behind it: no XLA fusion (the byte counts are an
eager step's) and no memory plan (peak memory is the most live storage).
The record's ``trace_s`` stands where the reference's ``compile_s`` stood.

Each combination is traced at 1 and 2 layers (the encoder-decoder family:
its encoder and decoder each) and extended linearly to the published depth
(``cost.extrapolate``), as ``hlo_cost`` multiplies a scan body by its trip
count.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --multi-pod both --out results/torch_dryrun
Each run prints the roofline row and (optionally) writes a JSON artifact
consumed by ``benchmarks/torch_roofline.py``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, canon,
                                 config_for_shape, get_config,
                                 shape_applicable)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.analysis import analyze, model_flops_estimate
from repro_torch.launch.cost import CostMode, StepCost, extrapolate
from repro_torch.launch.mesh import (make_production_mesh, placeholder_world,
                                     production_shape)
from repro_torch.models import transformer as tfm
from repro_torch.models.model import batch_spec, decode_specs
from repro_torch.sharding.annotate import DEFAULT_RULES, logical_axis_rules
from repro_torch.sharding.specs import (batch_specs, decode_cache_specs,
                                        param_specs, shard_meta)
from repro_torch.training.optimizer import Adam, AdamState
from repro_torch.training.train_loop import make_train_step


def depth(cfg: ModelConfig) -> Tuple[int, ...]:
    """The layer stacks' depths: (encoder, decoder) or (decoder,)."""
    return ((cfg.encoder_layers, cfg.num_layers) if cfg.is_encdec
            else (cfg.num_layers,))


def at_depth(cfg: ModelConfig, layers: Tuple[int, ...]) -> ModelConfig:
    if cfg.is_encdec:
        return cfg.replace(encoder_layers=layers[0], num_layers=layers[1])
    return cfg.replace(num_layers=layers[0])


def _f32_like(tree):
    return unflatten({k: torch.empty(v.shape, dtype=torch.float32,
                                     device="meta")
                      for k, v in flatten(tree).items()})


def trace_step(cfg: ModelConfig, shape: InputShape, mesh, *,
               attn_impl: str = "chunked", remat: str = "full",
               kv_shard: str = "heads", microbatch: int = 1,
               decode_params: str = "fsdp") -> StepCost:
    """One trace of ``shape.kind``'s step for ``cfg`` (at its own depth)
    on ``mesh``: its per-device :class:`~repro_torch.launch.cost.StepCost`.

    * train: ``make_train_step`` under ``Adam(clip_norm=1.0)``, the moments
      placed as the parameters;
    * prefill: ``forward_seq`` on the route ``attn_impl`` names, writing a
      fresh contiguous cache of ``min(seq_len, window)`` rows placed by
      ``decode_cache_specs(kv_shard)`` (the reference leaves the built
      cache's placement to XLA);
    * decode: ``decode_step`` on the contiguous cache, parameters without
      the FSDP dim when ``decode_params="tp"``."""
    fsdp = not (decode_params == "tp" and shape.kind == "decode")
    p = tfm.init_params(cfg, device="meta")
    params = shard_meta(p, param_specs(p, mesh, fsdp=fsdp), mesh)
    mode = CostMode()
    with logical_axis_rules(mesh, DEFAULT_RULES), implicit_replication():
        if shape.kind == "train":
            f32 = _f32_like(p)
            o_specs = param_specs(f32, mesh)
            state = AdamState(step=0, mu=shard_meta(f32, o_specs, mesh),
                              nu=shard_meta(f32, o_specs, mesh))
            b = batch_spec(cfg, shape)
            batch = shard_meta(b, batch_specs(b, mesh), mesh)
            step = make_train_step(cfg, Adam(learning_rate=1e-4,
                                             clip_norm=1.0),
                                   attn_impl=attn_impl, remat=remat,
                                   microbatch=microbatch)
            mode.track((params, state.mu, state.nu, batch))
            with mode:
                step(params, state, batch)
        elif shape.kind == "prefill":
            b = {k: v for k, v in batch_spec(cfg, shape).items()
                 if k not in ("targets", "loss_mask")}
            batch = shard_meta(b, batch_specs(b, mesh), mesh)
            cache_len = (min(shape.seq_len, cfg.sliding_window)
                         if cfg.sliding_window else shape.seq_len)
            c = tfm.init_cache(cfg, shape.global_batch, cache_len,
                               paged=False, device="meta")
            cache = shard_meta(c, decode_cache_specs(c, mesh,
                                                     kv_shard=kv_shard),
                               mesh)
            tokens = batch.pop("tokens")
            mode.track((params, batch, tokens, cache))
            with mode, torch.no_grad():
                tfm.forward_seq(params, cfg, tokens, cache=cache,
                                attn_impl=attn_impl, **batch)
        else:                                                # decode
            c, token = decode_specs(cfg, shape)
            cache = shard_meta(c, decode_cache_specs(c, mesh,
                                                     kv_shard=kv_shard),
                               mesh)
            token = shard_meta({"t": token},
                               batch_specs({"t": token}, mesh), mesh)["t"]
            mode.track((params, cache, token))
            with mode, torch.no_grad():
                tfm.decode_step(params, cfg, cache, token)
    return mode.cost


def step_cost(cfg: ModelConfig, shape: InputShape, mesh, **opts
              ) -> Tuple[StepCost, float]:
    """``(cost at cfg's depth, trace seconds)``: :func:`trace_step` at 1
    and 2 layers per stack, extended linearly (``cost.extrapolate``)."""
    full = depth(cfg)
    ones = (1,) * len(full)
    points = [ones] + [ones[:i] + (2,) + ones[i + 1:]
                       for i, n in enumerate(full) if n != 1]
    t0 = time.perf_counter()
    costs = {d: trace_step(at_depth(cfg, d), shape, mesh, **opts)
             for d in points}
    return extrapolate(costs, full), time.perf_counter() - t0


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                attn_impl: str = "chunked", remat: str = "full",
                kv_shard: str = "heads", moe_group: int = None,
                microbatch: int = 1, donate: bool = False,
                decode_params: str = "fsdp"):
    """Trace one (arch, shape, mesh). Returns (cost, meta). ``donate`` is
    recorded only: an eager step updates its parameters and cache in place
    whatever it is."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if not shape_applicable(cfg, shape):
        return None, {"skipped": True,
                      "reason": "long_500k inapplicable (DESIGN.md §5)"}
    cfg = config_for_shape(cfg, shape)
    if moe_group and cfg.moe is not None:
        cfg = cfg.replace(moe=cfg.moe.__class__(
            **{**cfg.moe.__dict__, "group_size": moe_group}))
    dims, _ = production_shape(multi_pod)
    n_dev = math.prod(dims)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    with placeholder_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod)
        cost, trace_s = step_cost(cfg, shape, mesh, attn_impl=attn_impl,
                                  remat=remat, kv_shard=kv_shard,
                                  microbatch=microbatch,
                                  decode_params=decode_params)
    meta = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": int(n_dev), "trace_s": trace_s,
        "attn_impl": attn_impl, "remat": remat, "kv_shard": kv_shard,
        "microbatch": microbatch, "donate": donate,
        "skipped": False,
    }
    return cost, meta


def run_one(arch, shape_name, *, multi_pod, out_dir=None, verbose=True,
            **kw):
    cost, meta = lower_combo(arch, shape_name, multi_pod=multi_pod, **kw)
    if meta.get("skipped"):
        if verbose:
            print(f"SKIP  {arch:22s} {shape_name:12s} — {meta['reason']}")
        return meta
    shape = INPUT_SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    rl = analyze(cost, arch=arch, shape=shape_name,
                 mesh_name=meta["mesh"], n_devices=meta["n_devices"],
                 model_flops=model_flops_estimate(cfg, shape))
    record = {**meta, **rl.asdict()}
    if verbose:
        print(f"OK    {rl.row()}  mem/dev="
              f"{round(rl.memory_gb_per_device, 2)}GB "
              f"trace={meta['trace_s']:.1f}s", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{canon(arch)}__{shape_name}__{meta['mesh']}"
        if kw.get("kv_shard", "heads") != "heads":
            tag += f"__kv-{kw['kv_shard']}"
        if kw.get("attn_impl", "chunked") != "chunked":
            tag += f"__attn-{kw['attn_impl']}"
        if kw.get("microbatch", 1) != 1:
            tag += f"__mb{kw['microbatch']}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="no", choices=["no", "yes", "both"])
    ap.add_argument("--attn-impl", default="chunked",
                    choices=["chunked", "naive"])
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--kv-shard", default="heads", choices=["heads", "seq"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--donate", action="store_true")
    ap.add_argument("--decode-params", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = [canon(args.arch)] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]

    failures = []
    t0 = time.perf_counter()
    for mp in pods:
        for arch in archs:
            for shape in shapes:
                try:
                    run_one(arch, shape, multi_pod=mp, out_dir=args.out,
                            attn_impl=args.attn_impl, remat=args.remat,
                            kv_shard=args.kv_shard, microbatch=args.microbatch,
                            donate=args.donate,
                            decode_params=args.decode_params)
                except Exception:
                    failures.append((arch, shape, mp))
                    print(f"FAIL  {arch:22s} {shape:12s} multi_pod={mp}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print(f"dry-run: all combos traced ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
