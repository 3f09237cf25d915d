"""What the check's logit gap reads on a latent-attention (``mla``) cell,
beside what rounding alone and planted faults read on the same tokens.

    python3 bench/mla_witness.py --workload <cell> --seed <n> \\
        [--seconds 51] [--program-fault scale_2.0|bias_ignored]

From the root of a checkout, on a machine with the cell's card. The run is
``bench/run.py``'s (``bench/harness/cell.py::run``, its check included).
On the requests, prompts and served tokens the check samples, other models
are then put in the program's place as the check's control is: at each
served position, how far that model's first choice lies below the f32
reference's best (``logit_gap_mean``, the widest ``logit_gap``, and
``logit_gap_share``, the share of positions where it is not the best):

- ``bf16``: the reference with the operands of every product rounded to
  bfloat16, the program's precision: what rounding alone gives;
- ``fp8``: the check's control, one precision further down;
- one per planted fault of ``FAULTS``, each the f32 reference with that
  fault: the routed experts' gates scaled by 2.0 in place of the
  configuration's factor, the router's selection bias ignored, and the
  rope columns taken in the interleaved order in place of rotate-half.

With ``--program-fault`` the program itself serves with the fault (scaled
gates through its config, or its router's bias ignored), so that the
check's own readings are those of a faulty program. The last line is
``witness: {...}``, the readings of each model; ``program`` is the check's.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from contextlib import ExitStack  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BF16 = "bf16"


def _scaled(params, model):
    return params, {**model, "routed_scaling_factor": 2.0}


def _bias_ignored(params, model):
    moe = params["layers"]["moe"]
    layers = {**params["layers"],
              "moe": {**moe, "router_bias": moe["router_bias"] * 0}}
    return {**params, "layers": layers}, model


def _rope_interleaved(params, model):
    """The rope columns of W_q (each head's last ``qk_rope_head_dim``) and
    of W_kva (its last) reordered: rotate-half over the reordered columns
    is the interleaved rope over the original ones."""
    import torch
    h, dn, dr = (model[k] for k in ("num_heads", "qk_nope_head_dim",
                                    "qk_rope_head_dim"))
    r = model["kv_lora_rank"]
    dev = params["embed"].device
    order = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)]).to(
        dev)

    def tree(t):
        a = t["attn"]
        wq = a["wq"].unflatten(-1, (h, dn + dr))
        wq = torch.cat([wq[..., :dn], wq[..., dn:][..., order]], -1)
        wkv = a["wkv_a"]
        wkv = torch.cat([wkv[..., :r], wkv[..., r:][..., order]], -1)
        return {**t, "attn": {**a, "wq": wq.flatten(-2), "wkv_a": wkv}}
    return {**params, "dense_layers": tree(params["dense_layers"]),
            "layers": tree(params["layers"])}, model


FAULTS = {"scale_2.0": _scaled, "bias_ignored": _bias_ignored,
          "rope_interleaved": _rope_interleaved}


def _round_to(original):
    import torch

    def round_to(x, precision):
        if precision == BF16:
            return x.to(torch.bfloat16).float()
        return original(x, precision)
    return round_to


def gaps(arch, params, model, inputs, reqs, device) -> dict:
    """Per model in the program's place (``bf16``, ``fp8``, each of
    ``FAULTS``): the mean and widest gap of its first choices below the f32
    reference's best, and the share of positions where they differ."""
    import torch

    from bench.reference.precision import F32, FP8
    models = {BF16: (params, model, BF16), "fp8": (params, model, FP8)}
    for name, plant in FAULTS.items():
        models[name] = (*plant(params, model), F32)
    got = {name: [] for name in models}
    for req in reqs:
        group, row, own, segs, positions, served = inputs.case(req, device)
        ref = arch.logits(params, model, group, row, own, segs, positions,
                          F32)
        best = ref.max(-1).values
        idx = torch.arange(len(served), device=device)
        for name, (p, m, precision) in models.items():
            pick = arch.logits(p, m, group, row, own, segs, positions,
                               precision).argmax(-1)
            got[name].append((best - ref[idx, pick]).cpu())
    out = {}
    for name, g in got.items():
        g = torch.cat(g).double()
        out[name] = {"logit_gap_mean": float(g.mean()),
                     "logit_gap": float(g.max()),
                     "logit_gap_share": float((g > 0).double().mean())}
    return out


def program_fault(cell, name: str, stack: ExitStack):
    """``cell`` with the program serving under the fault ``name``."""
    if name == "scale_2.0":
        arch = SimpleNamespace(**vars(cell.arch))
        arch.program_config = lambda cfg_json: cell.arch.program_config(
            cfg_json).replace(routed_scaling_factor=2.0)
        return dataclasses.replace(cell, arch=arch)
    if name == "bias_ignored":
        from repro_torch.models import moe
        gates = moe._sigmoid_gates
        stack.enter_context(mock.patch.object(
            moe, "_sigmoid_gates", lambda logits, bias, k, routing: gates(
                logits, bias * 0, k, routing)))
        return cell
    raise ValueError(f"no program side for the fault {name!r}")


def measure(cell, seed: int, seconds: float, device, log=print,
            fault: str = None) -> dict:
    """One run of ``cell`` (its program under ``fault`` where given) and
    the witness's readings on the requests its check sampled."""
    from bench.harness import cell as cell_mod, check
    from bench.reference import precision

    if cell.config.get("arch") != "mla":
        raise ValueError(f"{cell.name} is not an mla cell")
    seen = {}
    logit_gaps = check.logit_gaps

    def both(arch, params, model, inputs, reqs, device, control):
        out = logit_gaps(arch, params, model, inputs, reqs, device, control)
        seen.update(gaps(arch, params, model, inputs, reqs, device))
        return out
    with ExitStack() as stack:
        if fault:
            cell = program_fault(cell, fault, stack)
        stack.enter_context(mock.patch.object(check, "logit_gaps", both))
        stack.enter_context(mock.patch.object(
            precision, "round_to", _round_to(precision.round_to)))
        out = cell_mod.run(cell, seed, seconds, False, device, T_START,
                           log=log)
    r = out["readings"]
    seen["program"] = {k: r[k] for k in ("logit_gap_mean", "logit_gap",
                                         "logit_gap_share") if k in r}
    return {"out": out, "witness": seen}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--program-fault", choices=("scale_2.0", "bias_ignored"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import run as run_mod
    run_mod._caches()
    import torch

    from bench.harness import spec

    cell = spec.find(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card: no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__};"
          f" program fault {args.program_fault}", flush=True)
    res = measure(cell, args.seed, args.seconds, dev,
                  log=lambda s: print(s, flush=True),
                  fault=args.program_fault)
    out = res["out"]
    for line in out["info"]:
        print(line)
    print("readings: " + json.dumps(out["readings"]))
    print(f"correct {out['result']['correct']}, failed "
          f"{out['result']['failed']} of {out['result']['attempted']}")
    print("witness: " + json.dumps(res["witness"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
