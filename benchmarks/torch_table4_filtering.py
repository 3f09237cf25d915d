"""Paper Table IV: min_length_difference filtering ablation (δ on/off).

Twin of ``benchmarks/table4_filtering.py``: every predictor trains with the
port's trainer on ``device`` at the ``predictor`` width.

    PYTHONPATH=src python -m benchmarks.torch_table4_filtering \
        [--device cpu] [--predictor pars_bert_base]
"""
from __future__ import annotations

import sys
import time

from benchmarks.torch_common import FAST, combo, emit, get_predictor, tau_of
from repro_torch.data.synthetic import DATASETS, MODELS
from repro_torch.device import DeviceLike


def run(*, device: DeviceLike = "cuda", predictor: str = "mini") -> dict:
    combos = ([("alpaca", "gpt4"), ("alpaca", "r1"), ("lmsys", "llama")]
              if FAST else [(d, m) for d in DATASETS for m in MODELS])
    print("# Table IV analogue — tau_b with / without delta filtering")
    print(f"{'dataset':8s} {'model':6s} | {'without':>8s} {'with':>8s} {'delta':>6s}")
    results = {}
    t0 = time.perf_counter()
    for ds, m in combos:
        d = MODELS[m].delta
        without = tau_of(get_predictor(ds, m, delta=0.0, device=device,
                                       width=predictor), ds, m)
        with_f = tau_of(get_predictor(ds, m, delta=d, device=device,
                                      width=predictor), ds, m)
        results[(ds, m)] = (without, with_f)
        print(f"{ds:8s} {m:6s} | {without:8.3f} {with_f:8.3f} {d:6.2f}")
    us = (time.perf_counter() - t0) * 1e6
    gains = sum(1 for w, f in results.values() if f >= w - 0.01)
    emit("table4_filtering", us,
         f"filtering helps-or-ties in {gains}/{len(results)} combos")
    return results


def section(results: dict) -> dict:
    gains = sum(1 for w, f in results.values() if f >= w - 0.01)
    return {"tau": {combo(ds, m): {"without": w, "with": f,
                                   "delta": MODELS[m].delta}
                    for (ds, m), (w, f) in results.items()},
            "filtering_helps_or_ties": gains, "combos": len(results)}


if __name__ == "__main__":
    from benchmarks.torch_run import main
    main(["--only", "table4", *sys.argv[1:]])
