"""Paper §IV-D at full burst scale on the port: 2000 simultaneous requests,
five policies, avg + p90 per-token latency (simulator).

Twin of ``examples/burst_comparison.py`` (no JAX): the three predictors
train with the port's trainer on ``--device`` (``cuda`` by default, which
raises without a card), and the bursts run through the port's copy of the
simulator.

    python examples/torch_burst_comparison.py [--model r1]     # on the card
    PYTHONPATH=src python examples/torch_burst_comparison.py --device cpu
"""
import argparse

from repro_torch.core.predictor import TrainSettings, train_predictor
from repro_torch.core.scheduler.policies import fcfs, make_policy, oracle_sjf
from repro_torch.data.synthetic import MODELS, make_corpus, sample_lengths
from repro_torch.data.workload import burst_arrivals, make_requests
from repro_torch.serving.simulator import run_policy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama", choices=list(MODELS))
    ap.add_argument("--dataset", default="alpaca")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="bound the simulated KV cache (16-token blocks; "
                    "0 = unbounded) — admission defers under pressure")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    train_c = make_corpus(args.dataset, 1500, seed=0)
    L_train = sample_lengths(train_c, args.model)
    delta = MODELS[args.model].delta
    preds = {}
    for method in ("pairwise", "pointwise", "listwise"):
        preds[method] = train_predictor(
            train_c.prompts, L_train,
            settings=TrainSettings(method=method, epochs=2,
                                   pairs_per_epoch=2560, delta=delta),
            device=args.device)

    test_c = make_corpus(args.dataset, args.n, seed=5)
    L = sample_lengths(test_c, args.model, run_seed=2)
    reqs = make_requests(test_c, L, burst_arrivals(args.n))

    kv = args.kv_blocks or None
    print(f"\n{args.dataset}/{args.model}: burst n={args.n}, batch=16"
          + (f", kv_blocks={kv}" if kv else ""))
    reports = {}
    for name, pol in [
        ("fcfs", fcfs()),
        ("pointwise", make_policy("pointwise", preds["pointwise"])),
        ("listwise", make_policy("listwise", preds["listwise"])),
        ("pars", make_policy("pars", preds["pairwise"])),
        ("oracle", oracle_sjf()),
    ]:
        reports[name] = run_policy(reqs, pol, max_batch=16, kv_blocks=kv)
        print("  " + reports[name].row())
    f, p = reports["fcfs"], reports["pars"]
    print(f"\nPARS speedup vs FCFS: avg "
          f"{f.avg_per_token_latency / p.avg_per_token_latency:.2f}x, p90 "
          f"{f.p90_per_token_latency / p.p90_per_token_latency:.2f}x")


if __name__ == "__main__":
    main()
