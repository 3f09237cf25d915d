"""End-to-end run on the port: serve a model with batched requests
through the port's engine — real forwards, KV cache, continuous batching —
comparing FCFS / PARS / Oracle wall-clock per-token latency.

Twin of ``examples/serve_e2e.py`` (no JAX): the PARS predictor trains with
the port's trainer and the burst is served by the port's ``Engine``, both
on ``--device`` (``cuda`` by default, which raises without a card).
Without ``--full`` it serves the selected family's smoke config in f32
with ``vocab_size`` 2048, as the reference does; with ``--full`` the
published widths in their own dtype.

    python examples/torch_serve_e2e.py --full [--requests 48] [--batch 4]
    PYTHONPATH=src python examples/torch_serve_e2e.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.predictor import TrainSettings, train_predictor
from repro_torch.core.scheduler.policies import fcfs, make_policy, oracle_sjf
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.data.synthetic import make_corpus, sample_lengths
from repro_torch.data.workload import burst_arrivals, make_requests
from repro_torch.models import transformer as tfm
from repro_torch.serving import Engine, report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--arch", default="llama3_2_3b",
                    help="config family to serve")
    ap.add_argument("--max-len", type=int, default=120,
                    help="clip ground-truth lengths")
    ap.add_argument("--seq-prefill", action="store_true",
                    help="disable bucketed prefill (one dispatch per request)")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # the served LM: published widths, or the reduced config of the family
    cfg = (get_config(args.arch) if args.full else get_smoke_config(
        args.arch).replace(dtype="float32", vocab_size=2048))
    params = tfm.init_params(cfg, 0, device=args.device)
    print(f"serving {cfg.arch_id} ({'published' if args.full else 'reduced'}"
          f": {cfg.num_layers}L d{cfg.d_model} {cfg.dtype}) on "
          f"{params['embed'].device}")

    # train the PARS predictor on a disjoint prompt set
    train_c = make_corpus("alpaca", 1000, seed=1)
    pred = train_predictor(
        train_c.prompts, np.clip(sample_lengths(train_c, "llama"), 1,
                                 args.max_len),
        settings=TrainSettings(method="pairwise", epochs=2,
                               pairs_per_epoch=2048, delta=0.2),
        device=args.device)

    test_c = make_corpus("alpaca", args.requests, seed=9)
    lengths = np.clip(sample_lengths(test_c, "llama"), 1, args.max_len)

    print(f"\nburst of {args.requests} requests, engine batch={args.batch}, "
          f"real wall-clock:")
    for pol in [fcfs(), make_policy("pars", pred), oracle_sjf()]:
        reqs = make_requests(test_c, lengths, burst_arrivals(args.requests))
        sched = Scheduler(policy=pol, max_batch=args.batch)
        eng = Engine(cfg, params, sched, cache_len=256,
                     bucketed=not args.seq_prefill, device=args.device)
        eng.submit(reqs)
        finished = eng.run()
        rep = report(pol.name, finished)
        print("  " + rep.row())
        print(f"    admission: {eng.backend.prefill_requests} prefills in "
              f"{eng.backend.prefill_dispatches} dispatches "
              f"({eng.backend.prefill_seconds * 1e3:.0f} ms)")


if __name__ == "__main__":
    main()
