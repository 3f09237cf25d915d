"""One run of one cell: set-up, the measured window, the metrics, and the
check of what the window produced.

Set-up (``setup_s``, from the process's start): the traffic, the weights
drawn on the device by the cell's architecture (``bench/archs``), the
predictor trained, the engine built and warmed up. The window: the
traffic's requests served from a clock origin, for ``seconds``; a burst
mix's requests are then served to their end, for at most ``seconds``
more. After the window the device's peak memory is read, the engine's
caches are freed and the reference judges the output.
"""
from __future__ import annotations

import gc
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.harness import check, predictor, serve, spec, traffic

SLICE_S = 3.0           # profiled seconds of a traced run
SLICE_LEAD_S = 1.0      # the profiler starts this long before a burst
SAMPLE_TOKENS = 600     # served tokens the check reads, at least ...
SAMPLE_LEAST = 4        # ... from at least this many requests ...
SAMPLE_MOST = 64        # ... and at most this many (a batch window
                        # finishes mostly short requests)


def predictor_for(cfg_json: dict, mix: dict, seed: int, device, log):
    """The program's ``RankingPredictor`` over weights the benchmark
    trained."""
    from repro_torch.core.predictor.backbones import PredictorConfig
    from repro_torch.core.predictor.tokenizer import HashTokenizer
    from repro_torch.core.predictor.train import RankingPredictor

    pc = cfg_json["predictor"]
    prompts, lengths = traffic.training_set(mix, seed, pc["train"]["rows"])
    params = predictor.train(pc, prompts, lengths, seed, device, log)
    cfg = PredictorConfig(**{k: pc[k] for k in (
        "backbone", "vocab_size", "max_len", "d_model", "num_heads",
        "num_layers", "d_ff")})
    tok = HashTokenizer(vocab_size=pc["vocab_size"], max_len=pc["max_len"])
    return RankingPredictor(cfg, params, tok), params


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print, control: bool = False,
        trace_path: Optional[str] = None) -> Dict:
    """One run; returns the result (the line's keys) and what the lines
    before it print (``info``)."""
    from repro_torch.core.scheduler.request import Request

    cfg_json, mix = cell.config, cell.mix
    model, engine_cfg = cfg_json["model"], cfg_json["engine"]
    bursts = mix["arrivals"] == "bursts"
    interval = float(cell.own.get("burst_interval_s", 0.0))
    items = traffic.generate(mix, seed, seconds, interval)
    cfg = cell.arch.program_config(cfg_json)
    params = cell.arch.make_params(cfg, seed, device)
    pred, pred_params = predictor_for(cfg_json, mix, seed, device, log)
    engine, scorer = serve.build(cfg, params, cfg_json, pred, device)
    serve.warm_up(engine, cfg_json)
    warm_prof = serve.warm_profiler(engine) if trace else None
    requests = [Request(req_id=i.req_id, prompt=i.prompt,
                        arrival_time=i.arrival, prompt_len=i.prompt_tokens,
                        true_length=i.output_tokens) for i in items]
    gc.collect()
    gc.freeze()      # set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t_start
    # a burst is admitted under a live profiler: it starts before the
    # burst is due, and its slice runs from when it is up
    slice_at = (max(interval - SLICE_LEAD_S, 0.0)
                if bursts and interval < seconds else min(10.0, seconds / 3))
    slice_s = min(SLICE_S, max(seconds - slice_at, 0.5))
    window = serve.run_window(engine, scorer, requests, seconds,
                              drain=bursts, trace=trace, slice_at=slice_at,
                              slice_s=slice_s, trace_path=trace_path)
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    ctx = SimpleNamespace(window=window, arch=cell.arch, model=model,
                          engine=engine_cfg,
                          engine_paged=engine.backend.paged,
                          attempted=requests, cut=window.serve_s, T=seconds)
    metrics = {} if trace else {"setup_s": {"value": setup_s, "unit": "s"}}
    for m in cell.per_layer if trace else cell.end_to_end:
        if m["name"] == "setup_s":
            continue
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    finished = [r for r in requests if r.finish_time is not None]
    dropped = list(engine.core.dropped)
    failed = (len(requests) - len(finished)) if bursts else len(dropped)
    info = _info(window, requests, items, bursts, interval)
    info.append(window.host.line([st for st in window.steps
                                  if st[1] <= seconds]))
    if trace:
        info.append(f"profiler: warmed in set-up in {warm_prof:.3f} s; "
                    f"paused serving for " + ", ".join(
                        f"{b - a:.3f} s at {a:.3f} s"
                        for a, b in window.paused))
    serve.free(engine)
    del engine, scorer, pred

    checks: Dict[str, Dict] = {}
    readings: Dict[str, Optional[float]] = {}
    limits = cfg_json["limits"]
    t_check = time.perf_counter()
    try:
        sampled = check.sample(finished, seed, SAMPLE_TOKENS, SAMPLE_MOST,
                               SAMPLE_LEAST)
        inputs = check.Inputs(model, engine_cfg, window)
        readings.update(check.logit_gaps(cell.arch, params, model, inputs,
                                         sampled, device, control))
        readings.update(check.score_gaps(pred_params, cfg_json["predictor"],
                                         window, requests, device, control))
        readings["prefix_hits"] = window.prefix_installs
        # with ``control`` the control stands in the program's place and
        # is judged by the same limits (it has to come out not correct)
        for k, limit in limits.items():
            value = readings.get(k + "_control" if control and
                                 k + "_control" in readings else k)
            checks[k] = {"value": value, "limit": limit}
        correct = bool(checks) and all(
            c["value"] is not None and c["limit"] is not None
            and c["value"] <= c["limit"] for c in checks.values())
    except Exception:                         # noqa: BLE001
        traceback.print_exc()
        correct = False
    info.append(f"check of {readings.get('requests', 0)} requests, "
                f"{readings.get('tokens', 0)} served tokens: "
                f"{time.perf_counter() - t_check:.1f} s")
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": int(failed), "metrics": metrics}
    if trace and window.slice is not None:
        result["breakdown"] = {"device_ops": window.slice.top_ops(),
                               "idle_gaps": window.slice.idle_gaps()}
    return {"result": result, "checks": checks, "readings": readings,
            "info": info, "memory_peak_bytes": int(peak), "window": window}


def _info(w, requests, items, bursts: bool, interval: float) -> List[str]:
    done = sum(r.finish_time is not None for r in requests)
    lines = [f"requests sent {len(requests)}, finished {done}, "
             f"unfinished {len(requests) - done}, served for "
             f"{w.serve_s:.3f} s, prefix hits {w.prefix_installs}",
             f"output tokens {sum(i.output_tokens for i in items)} "
             f"(mean {np.mean([i.output_tokens for i in items]):.2f}), "
             f"prompt tokens mean "
             f"{np.mean([i.prompt_tokens for i in items]):.2f}"]
    if bursts:
        lines.append(f"burst interval {interval:g} s, bursts "
                     f"{len(set(r.arrival_time for r in requests))}")
        for t in sorted(set(r.arrival_time for r in requests)):
            mine = [r for r in requests if r.arrival_time == t]
            started = [r.start_time for r in mine if r.start_time is not None]
            last_start = max(started) - t if started else float("nan")
            end = w.drained_by.get(t, float("nan")) - t
            lines.append(f"  burst at {t:g} s: all admitted by "
                         f"+{last_start:.3f} s, all finished by +{end:.3f} s"
                         f" (next burst +{interval:g} s)")
    else:
        lines.append(f"backlog left at the window's end {w.backlog} of "
                     f"{len(requests)}")
    return lines
