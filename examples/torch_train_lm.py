"""Train a language model with the port's training substrate.

Twin of ``examples/train_lm.py`` on PyTorch: any architecture family is
selectable; the default trains a reduced config (f32) for a few hundred
steps on synthetic LM data and checkpoints it; ``--full`` takes the
published config in its dtype on one card.

    PYTHONPATH=src python examples/torch_train_lm.py --arch llama3.2-3b \\
        --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --arch whisper-tiny \\
        --device cpu --steps 50

The recipe is the reference's: ``build(cfg)`` parameters from seed 0, a
fresh ``example_batch`` every step (seed ``0 + step``; an audio batch
carries its stub frames), Adam on a cosine schedule (3e-4, 20 warmup
steps) with global-norm clipping at 1.0, the ``train`` driver (remat
``"full"``, a record every 20 steps), a checkpoint in the reference's
format, and the assertion that the last recorded loss is below the first.
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build, example_batch
from repro_torch.training import Adam, cosine_schedule, save_checkpoint, train


def batches(cfg, batch_size, seq, device, seed=0):
    i = 0
    while True:
        yield example_batch(cfg, batch_size, seq, seed + i, device=device)
        i += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (card scale)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_lm_ckpt.npz"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_config(args.arch) if args.full
           else get_smoke_config(args.arch).replace(dtype="float32"))
    bundle = build(cfg, remat="none" if not args.full else "full")
    params = bundle.init(0, device=args.device)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"training {cfg.arch_id}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps")

    opt = Adam(learning_rate=cosine_schedule(3e-4, warmup=20,
                                             total=args.steps),
               clip_norm=1.0)
    params, history = train(
        cfg, params, batches(cfg, args.batch, args.seq, args.device),
        opt=opt, steps=args.steps, log_every=20)
    save_checkpoint(args.out, params, metadata={"arch": cfg.arch_id,
                                                "steps": args.steps})
    print(f"checkpoint written to {args.out}")
    assert history[-1]["loss"] < history[0]["loss"]
    return history


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
