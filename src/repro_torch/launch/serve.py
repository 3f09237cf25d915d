"""Serving launcher: PARS-scheduled continuous batching on the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy pars --requests 32
    PYTHONPATH=src python -m repro_torch.launch.serve --full            # 3B, bf16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu      # smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b --full

Twin of ``repro/launch/serve.py``. Builds the engine around the chosen
architecture (one the port runs: the dense ``llama3_2_3b``,
``nemotron_4_15b`` and ``command_r_35b``, the MoE ``olmoe_1b_7b``,
``moonshot_v1_16b_a3b`` and ``kimi_k2_1t_a32b``, Qwen2-VL's backbone
``qwen2_vl_72b``, the hybrid ``hymba_1_5b`` or the attention-free
``rwkv6_7b``; its f32 smoke config, or with ``--full`` its published widths
in bf16, where the weights fit the device: ``kimi_k2_1t_a32b`` and
``qwen2_vl_72b`` do not fit one H100, and ``--full`` says so), with seeded
random weights, serves a burst (or a Poisson stream), and prints the
paper's latency metrics. The cache follows the architecture, as in the
reference: a paged KV pool for the dense, MoE and VLM models, contiguous
ring lanes for the sliding-window hybrid ``hymba_1_5b``, per-slot
recurrent state for ``rwkv6_7b``. PARS-family policies rank with
a predictor trained here as the reference's launcher trains it
(:func:`train_ranker`: 1000 alpaca prompts, the workload's lengths clipped
to ``--max-len``, two epochs of 2048 δ-filtered pairs, at the mini width
or, with ``--full``, at ``pars_bert_base``'s BERT-base width), or loaded
from ``--predictor PATH.npz`` (a checkpoint of ``RankingPredictor.save``,
the port's or the reference's).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs import pars_bert_base
from repro_torch.core.predictor.tokenizer import HashTokenizer
from repro_torch.core.predictor.train import (RankingPredictor, TrainSettings,
                                              train_predictor)
from repro_torch.core.scheduler.policies import make_policy
from repro_torch.data.synthetic import MODELS, make_corpus, sample_lengths
from repro_torch.data.workload import (burst_arrivals, make_requests,
                                       poisson_arrivals)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.serving import serve


def ported_archs() -> list:
    """The architectures whose family the port runs."""
    out = []
    for arch in ARCH_IDS:
        try:
            tfm.check_supported(get_config(arch))
        except NotImplementedError:
            continue
        out.append(arch)
    return out


def train_ranker(policy: str, workload: str, max_len: int, *, full: bool,
                 device, epochs: int = 2, log_fn=print) -> RankingPredictor:
    """The ranking predictor of a PARS-family ``policy`` (``pars``,
    ``pointwise`` or ``listwise``), trained as the reference's launcher
    trains it (two epochs), at the mini width or (``full``) at
    ``pars_bert_base``'s. Runs of fewer ``epochs`` see the same first
    batches from the same seed."""
    method = {"pars": "pairwise"}.get(policy, policy)
    c_train = make_corpus("alpaca", 1000, seed=1)
    lengths = np.clip(sample_lengths(c_train, workload), 1, max_len)
    tokenizer, pcfg = None, None
    if full:
        pcfg = pars_bert_base.CONFIG
        tokenizer = HashTokenizer(vocab_size=pcfg.vocab_size,
                                  max_len=pcfg.max_len)
    return train_predictor(
        c_train.prompts, lengths,
        settings=TrainSettings(method=method, epochs=epochs,
                               pairs_per_epoch=2048,
                               delta=MODELS[workload].delta),
        tokenizer=tokenizer, pcfg=pcfg, log_fn=log_fn, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b",
                    choices=ported_archs())
    ap.add_argument("--policy", default="pars",
                    choices=["fcfs", "pars", "pointwise", "listwise", "oracle"])
    ap.add_argument("--workload", default="llama", choices=list(MODELS))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="poisson req/s (0 = burst)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=120)
    ap.add_argument("--starvation", type=float, default=120.0)
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="KV cache budget in 16-token blocks "
                    "(0 = max_batch lanes of cache_len)")
    ap.add_argument("--seq-prefill", action="store_true",
                    help="disable bucketed prefill (one dispatch per request)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="published widths in bf16 instead of the f32 smoke "
                    "config")
    ap.add_argument("--predictor", default=None, metavar="PATH.npz",
                    help="ranking-predictor checkpoint (default: train one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.full else
           get_smoke_config(args.arch).replace(dtype="float32",
                                               vocab_size=2048))
    tfm.require_fit(cfg, dev, getattr(torch, cfg.dtype).itemsize)

    predictor = None
    if args.policy in ("pars", "pointwise", "listwise"):
        predictor = (RankingPredictor.load(args.predictor, device=dev)
                     if args.predictor else
                     train_ranker(args.policy, args.workload, args.max_len,
                                  full=args.full, device=dev))
    policy = make_policy(args.policy, predictor)
    params = tfm.init_params(cfg, 0, device=dev)

    c = make_corpus("alpaca", args.requests, seed=9)
    lengths = np.clip(sample_lengths(c, args.workload), 1, args.max_len)
    arrivals = (burst_arrivals(args.requests) if args.rate <= 0
                else poisson_arrivals(args.requests, args.rate, seed=2))
    reqs = make_requests(c, lengths, arrivals)

    rep = serve(cfg, params, reqs, policy, max_batch=args.batch,
                cache_len=256, starvation_threshold=args.starvation,
                kv_blocks=args.kv_blocks or None,
                bucketed=not args.seq_prefill, device=dev)
    print(rep.row())
    return rep


if __name__ == "__main__":
    main()
