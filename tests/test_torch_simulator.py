"""The port's copies of the simulator, router, SLO workloads, faults and
metrics against the reference.

The copies are the reference's code with ``repro.`` rewritten
(``tests/test_torch_boundary.py``), so each run here gives both packages
the same requests and policies and holds the resulting
``LatencyReport``/``SLOReport``/``RouterReport`` equal field by field,
exactly (NaN equal to NaN).
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.scheduler.policies as ref_policies
import repro.core.scheduler.request as ref_request
import repro.core.scheduler.scheduler as ref_scheduler
import repro.serving.config as ref_config
import repro.serving.faults as ref_faults
import repro.serving.metrics as ref_metrics
import repro.serving.simulator as ref_simulator
import repro.serving.workloads as ref_workloads
import repro_torch.core.scheduler.policies as port_policies
import repro_torch.core.scheduler.request as port_request
import repro_torch.core.scheduler.scheduler as port_scheduler
import repro_torch.serving.config as port_config
import repro_torch.serving.faults as port_faults
import repro_torch.serving.metrics as port_metrics
import repro_torch.serving.simulator as port_simulator
import repro_torch.serving.workloads as port_workloads
from repro_torch.serving import ROUTING_POLICIES

SIDES = {
    "ref": SimpleNamespace(req=ref_request, pol=ref_policies,
                           sched=ref_scheduler, sim=ref_simulator,
                           met=ref_metrics, wl=ref_workloads, flt=ref_faults,
                           cfg=ref_config),
    "port": SimpleNamespace(req=port_request, pol=port_policies,
                            sched=port_scheduler, sim=port_simulator,
                            met=port_metrics, wl=port_workloads,
                            flt=port_faults, cfg=port_config),
}


def _same(a, b, path="report"):
    """Exact equality of two plain structures, NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), f"{path}: {a} != {b}"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _plain(report):
    return dataclasses.asdict(report)


def _rows(n=120, seed=0, stagger=0.0, shared_prefix=False):
    """(req_id, prompt, arrival, prompt_len, true_length) of a trace:
    lengths from a seeded numpy rng; optionally every other prompt opens
    with a shared 40-word system prompt (prefix-cache hits)."""
    rng = np.random.default_rng(seed)
    system = " ".join(f"rule{j}" for j in range(40))
    rows = []
    for i in range(n):
        words = [f"w{int(x)}" for x in rng.integers(0, 500,
                                                    rng.integers(3, 30))]
        prompt = " ".join(words)
        if shared_prefix and i % 2 == 0:
            prompt = f"{system} {prompt}"
        rows.append((i, prompt, i * stagger, len(prompt.split()),
                     int(rng.integers(1, 200))))
    return rows


def _requests(side, rows):
    return [side.req.Request(*r) for r in rows]


def _len_scorer(prompts):
    """A fixed scorer: the same numbers in both packages."""
    return [float(len(p) % 97) for p in prompts]


def _policy(side, name):
    if name == "fcfs":
        return side.pol.fcfs()
    if name == "oracle":
        return side.pol.oracle_sjf()
    if name == "pars+":
        return side.pol.make_policy("pars+", _len_scorer, alpha=0.5,
                                    score_scale=20.0)
    return side.pol.make_policy(name, _len_scorer)


RUN_CONFIGS = {
    "default": {},
    "kv_chunked": dict(kv_blocks=96, prefill_chunk_tokens=32),
    "prefix_cached": dict(kv_blocks=256, prefix_caching=True),
    "incremental_rerank": dict(kv_blocks=128,
                               kv_reservation="incremental",
                               rerank_every_steps=4),
}


@pytest.mark.parametrize("config", list(RUN_CONFIGS))
@pytest.mark.parametrize("policy", ["fcfs", "pars", "pars+", "oracle"])
def test_run_policy_matches_reference(policy, config):
    rows = _rows(shared_prefix=config == "prefix_cached", stagger=0.01)
    reports = [
        s.sim.run_policy(_requests(s, rows), _policy(s, policy),
                         max_batch=8, **RUN_CONFIGS[config])
        for s in SIDES.values()]
    assert reports[1].n_requests == len(rows)
    _same(_plain(reports[0]), _plain(reports[1]))


def test_simulate_matches_reference_request_by_request():
    """Every finished request's timestamps and counters, under PARS with
    preemption and a bounded KV budget."""
    rows = _rows(n=80, seed=2, stagger=0.02)
    fins = []
    for s in SIDES.values():
        sched = s.sched.Scheduler(policy=_policy(s, "pars"), max_batch=6,
                                  preemption=True)
        fins.append(s.sim.simulate(_requests(s, rows), sched, kv_blocks=64))
    fields = ("req_id", "start_time", "first_token_time", "finish_time",
              "tokens_done", "score", "preempt_count")
    assert len(fins[0]) == len(fins[1]) == len(rows)
    for a, b in zip(fins[0], fins[1]):
        _same({f: getattr(a, f) for f in fields},
              {f: getattr(b, f) for f in fields}, f"request {a.req_id}")
    _same(_plain(SIDES["ref"].met.report("pars", fins[0])),
          _plain(SIDES["port"].met.report("pars", fins[1])))


@pytest.mark.parametrize("routing", ROUTING_POLICIES)
def test_simulate_replicas_matches_reference(routing):
    rows = _rows(n=150, seed=3, stagger=0.005, shared_prefix=True)
    routers = []
    for s in SIDES.values():
        routers.append(s.sim.simulate_replicas(
            _requests(s, rows), n_replicas=3,
            policy_factory=lambda s=s: _policy(s, "pars"), routing=routing,
            kv_blocks=160, max_batch=8, prefix_caching=True, seed=5))
    assert routers[0].assignment_log == routers[1].assignment_log
    _same(_plain(routers[0].report()), _plain(routers[1].report()))


def _workload_spec(wl):
    return wl.WorkloadSpec(
        tenants=(
            wl.TenantSpec(
                name="chat",
                phases=(wl.ArrivalPhase(3.0, 4.0), wl.ArrivalPhase(0.5, 4.0)),
                classes=(wl.PriorityClass("interactive",
                                          slo=wl.SLO(ttft_s=1.0, itl_s=0.1),
                                          priority=1, weight=1.0),
                         wl.PriorityClass("batch", weight=2.0)),
                outputs=wl.OutputDist(median_tokens=16, sigma=0.5),
                conversation=wl.ConversationSpec(max_turns=3,
                                                 p_continue=0.7,
                                                 think_time_s=0.5,
                                                 turn_words=8,
                                                 echo_cap_words=16),
                system_words=32),
            wl.TenantSpec(
                name="docs", phases=(wl.ArrivalPhase(1.0, 8.0),),
                outputs=wl.OutputDist(median_tokens=40, sigma=0.6,
                                      long_frac=0.2, long_scale=4.0))),
        duration_s=8.0, seed=7)


def test_workload_trace_and_slo_report_match_reference():
    traces, slos, lats = [], [], []
    for s in SIDES.values():
        trace = s.wl.generate_trace(_workload_spec(s.wl))
        traces.append(trace)
        core = s.sim.make_sim_core(
            s.sched.Scheduler(policy=_policy(s, "pars"), max_batch=8),
            kv_blocks=512, config=s.cfg.ServingConfig(prefix_caching=True))
        core.submit(s.sim.clone_requests(trace))
        fin = core.run()
        slos.append(s.met.slo_report("pars", fin, core.dropped))
        lats.append(s.met.report("pars", fin))
    fields = ("req_id", "prompt", "arrival_time", "prompt_len", "true_length",
              "tenant", "priority_class", "priority", "slo_ttft_s",
              "slo_itl_s")
    assert len(traces[0]) == len(traces[1]) > 20
    for a, b in zip(*traces):
        _same({f: getattr(a, f) for f in fields},
              {f: getattr(b, f) for f in fields}, f"request {a.req_id}")
    _same(SIDES["ref"].wl.trace_summary(traces[0]),
          SIDES["port"].wl.trace_summary(traces[1]))
    _same(_plain(slos[0]), _plain(slos[1]))
    _same(_plain(lats[0]), _plain(lats[1]))


def test_replica_crash_failover_matches_reference():
    rows = _rows(n=60, seed=4, stagger=0.02)
    out = []
    for s in SIDES.values():
        faults = s.flt.FaultSchedule(crashes=(
            s.flt.ReplicaCrash(replica=0, at_step=6, down_events=40),))
        rt = s.sim.simulate_replicas(
            _requests(s, rows), n_replicas=2, policy_factory=s.pol.fcfs,
            routing="round_robin", faults=faults)
        out.append((faults.injected_crashes, rt.redispatches,
                    [r.req_id for r in rt.all_dropped], _plain(rt.report())))
    assert out[1][0] == 1 and out[1][1] >= 1
    _same(out[0], out[1])


def test_scorer_outage_degradation_matches_reference():
    rows = _rows(n=60, seed=5, stagger=0.03)
    out = []
    for s in SIDES.values():
        faults = s.flt.FaultSchedule(scorer_outages=(
            s.flt.ScorerOutage(first_call=1, n_calls=3, kind="timeout"),))
        pol = s.pol.predictor_sjf("pars", faults.wrap_scorer(_len_scorer),
                                  scorer_failure_budget=2)
        fin = s.sim.simulate(_requests(s, rows),
                             s.sched.Scheduler(policy=pol, max_batch=4),
                             faults=faults)
        rep = s.met.report("pars", fin, scorer_failures=pol.scorer_failures,
                           degradations=pol.degradations,
                           recoveries=pol.recoveries)
        out.append((faults.injected_scorer_faults, pol.degradations,
                    pol.recoveries, _plain(rep)))
    assert out[1][0] == 3 and out[1][1] >= 1
    _same(out[0], out[1])


def test_chaos_schedule_matches_reference():
    """``FaultSchedule.chaos`` draws from a seeded ``random.Random``: the
    same plan in both packages, and the same routed run under it."""
    rows = _rows(n=100, seed=6, stagger=0.01)
    out = []
    for s in SIDES.values():
        faults = s.flt.FaultSchedule.chaos(11, n_replicas=3,
                                           horizon_steps=60,
                                           arrival_skew_s=0.05)
        plan = (faults.crashes, faults.scorer_outages, faults.grow_storms,
                faults.arrival_skew)
        rt = s.sim.simulate_replicas(
            _requests(s, rows), n_replicas=3,
            policy_factory=lambda s=s, f=faults: s.pol.predictor_sjf(
                "pars", f.wrap_scorer(_len_scorer)),
            routing="least_kv_pressure", kv_blocks=96,
            kv_reservation="incremental", faults=faults)
        out.append(([dataclasses.astuple(x) if x is not None else None
                     for group in plan[:3] for x in group]
                    + [plan[3] and plan[3].max_abs_s],
                    faults.injected_crashes, faults.injected_grow_denials,
                    _plain(rt.report())))
    _same(out[0], out[1])
