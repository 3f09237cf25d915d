"""Training launcher: the LM's train step on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 10

Twin of ``repro/launch/train.py`` without a mesh: one device, every family
(a VLM batch carries its stub vision prefix, an audio batch its stub
frames). The smoke config runs in f32 with ``remat="none"``; ``--full``
takes the published config in its dtype (bf16) with ``remat="full"``,
where its weights, gradients and Adam's two f32 moments (12 bytes a bf16
parameter) fit the device, and says so, before allocating, where they do
not (``tfm.require_fit``: ``rwkv6_7b``'s 7.5 B parameters need 90 GB, more
than an 80 GB card holds). Seeded random
weights, a fresh random batch every step (``example_batch``, seed
``1 + step``), Adam with a cosine schedule (3e-4, 5 warmup steps) and
global-norm clipping at 1.0, as the reference.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import canon, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import example_batch
from repro_torch.models import transformer as tfm
from repro_torch.training import Adam, cosine_schedule, save_checkpoint
from repro_torch.training.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="published config in its dtype, remat='full'")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = canon(args.arch)
    cfg = (get_config(arch) if args.full
           else get_smoke_config(arch).replace(dtype="float32"))
    tfm.require_fit(cfg, dev, 2 * getattr(torch, cfg.dtype).itemsize + 8)
    print(f"training {cfg.arch_id} on {dev}")

    opt = Adam(learning_rate=cosine_schedule(3e-4, 5, args.steps),
               clip_norm=1.0)
    step_fn = make_train_step(cfg, opt, remat="full" if args.full else "none",
                              microbatch=args.microbatch)
    params = tfm.init_params(cfg, 0, device=dev)
    opt_state = opt.init(params)
    history = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = example_batch(cfg, args.batch, args.seq, 1 + i, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {history[-1]['loss']:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, metadata={"arch": cfg.arch_id})
        print("checkpoint:", args.ckpt)
    return params, history


if __name__ == "__main__":
    main()
