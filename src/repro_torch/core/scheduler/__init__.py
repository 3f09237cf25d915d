"""Predictor-guided scheduler (paper §III-B): policies + W/R queue engine."""
from repro_torch.core.scheduler.policies import POLICY_NAMES, Policy, fcfs, make_policy, oracle_sjf, predictor_sjf
from repro_torch.core.scheduler.request import Request, RequestState
from repro_torch.core.scheduler.scheduler import DEFAULT_STARVATION_S, Scheduler
