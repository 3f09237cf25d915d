"""Serving runtime: the copied ServingCore step loop, KV block accounting,
metrics, faults, multi-replica router, discrete-event simulator and SLO
workloads, and the paged PyTorch engine on the port's CUDA kernels."""
from repro_torch.serving.config import ServingConfig, resolve_config
from repro_torch.serving.core import (PrefillChunk, ServingCore, VirtualClock,
                                      WallClock)
from repro_torch.serving.engine import Engine, RealBackend, serve
from repro_torch.serving.faults import (ArrivalSkew, FaultSchedule, GrowStorm,
                                        ReplicaCrash, ReplicaCrashed,
                                        ScorerError, ScorerOutage,
                                        ScorerTimeout)
from repro_torch.serving.kv_cache import BlockAllocator, prefix_chunk_hashes
from repro_torch.serving.metrics import (ClassSLOStats, LatencyReport,
                                         RouterReport, RunCounters, SLOReport,
                                         TenantStats, itl_samples, meets_itl,
                                         meets_slo, meets_ttft, report,
                                         router_report, slo_report)
from repro_torch.serving.router import (ROUTING_POLICIES, ReplicaRouter,
                                        score_predicted_len)
from repro_torch.serving.sampler import SamplerConfig, filter_logits, sample
from repro_torch.serving.simulator import (CostModel, SimBackend,
                                           clone_requests, make_sim_core,
                                           make_sim_replicas, run_policy,
                                           simulate, simulate_replicas)
from repro_torch.serving.workloads import (SLO, ArrivalPhase,
                                           ConversationSpec, OutputDist,
                                           PriorityClass, TenantSpec,
                                           WorkloadSpec, generate_trace,
                                           trace_summary)
