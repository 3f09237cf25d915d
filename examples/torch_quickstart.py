"""Quickstart on the port: train a PARS predictor and schedule a burst.

Twin of ``examples/quickstart.py`` (no JAX): the predictor trains with the
port's trainer on ``--device`` (``cuda`` by default, which raises without a
card), and the burst runs through the port's copy of the simulator.

    python examples/torch_quickstart.py                  # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.core.predictor import (TrainSettings, evaluate_tau,
                                        train_predictor)
from repro_torch.core.scheduler.policies import fcfs, make_policy, oracle_sjf
from repro_torch.data.synthetic import make_corpus, sample_lengths
from repro_torch.data.workload import burst_arrivals, make_requests
from repro_torch.serving.simulator import run_policy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # 1. data: synthetic "Alpaca-like" prompts + Llama-like response lengths
    train_c = make_corpus("alpaca", 1200, seed=0)
    test_c = make_corpus("alpaca", 400, seed=7)
    train_len = sample_lengths(train_c, "llama")
    test_len = sample_lengths(test_c, "llama", run_seed=3)

    # 2. pairwise predictor with margin ranking loss + delta filtering (§III-A)
    pred = train_predictor(
        train_c.prompts, train_len,
        settings=TrainSettings(method="pairwise", epochs=2,
                               pairs_per_epoch=2560, delta=0.2),
        log_fn=print, device=args.device)
    tau = evaluate_tau(pred, test_c.prompts, test_len)
    print(f"\nKendall tau_b on held-out prompts: {tau:.3f}")

    print("\nsample scores (higher = longer expected response):")
    for p in ["what is topic3", "prove topic42 derive topic42",
              "summarize topic10 please"]:
        print(f"  {pred.score([p])[0]:+7.3f}  {p!r}")

    # 3. predictor-guided SJF vs FCFS vs Oracle on a 400-request burst (§III-B)
    reqs = make_requests(test_c, test_len, burst_arrivals(400))
    print("\nburst of 400 requests, continuous batching (batch=16):")
    for pol in [fcfs(), make_policy("pars", pred), oracle_sjf()]:
        print("  " + run_policy(reqs, pol, max_batch=16).row())


if __name__ == "__main__":
    main()
