"""Serving runtime: the copied ServingCore step loop, KV block accounting and
metrics, and the paged PyTorch engine on the port's CUDA kernels."""
from repro_torch.serving.config import ServingConfig, resolve_config
from repro_torch.serving.core import (PrefillChunk, ServingCore, VirtualClock,
                                      WallClock)
from repro_torch.serving.engine import Engine, RealBackend, serve
from repro_torch.serving.faults import ReplicaCrashed
from repro_torch.serving.kv_cache import BlockAllocator, prefix_chunk_hashes
from repro_torch.serving.metrics import (LatencyReport, RunCounters,
                                         itl_samples, report)
from repro_torch.serving.sampler import SamplerConfig, filter_logits, sample
