"""Real PyTorch serving backend: continuous batching over paged or
contiguous KV.

Port of ``repro/serving/engine.py``. The backend plugs into the copied
:class:`~repro_torch.serving.core.ServingCore` step loop (scheduler, PARS
ranking, KV block accounting, chunk planning and prefix caching are the
reference's code), and keeps the reference's backend contract:
``kv_demand`` / ``prefill_total`` / ``prefix_tokens`` / ``release`` have the
same semantics, so the core makes the same decisions. Two KV modes, chosen
as the reference chooses (``paged=None``: paged for attention-only models,
the dense, MoE and VLM families, without a sliding window):

* **Paged.** KV lives in one global pool per K and V, ``(L, total_blocks +
  1, block_size, KH, dh)`` (the reference's ``(n+1, L, bs, KH, dh)`` with L
  moved to the front, so that one layer's pool is contiguous), indexed by
  each request's allocator block table; the trailing *null* block pads
  tables and is only ever read under the length mask. Prefix caching is
  zero-copy: the allocator aliased the cached blocks into the new request's
  table, so a hit just claims a slot and resumes at the cached offset
  (``prefix_tokens_copied`` stays 0). Decode reads the pool through the
  tables with the paged decode kernel. A latent (MLA) model's pool is one
  pool of latent rows, ``(L, total_blocks + 1, block_size, kv_lora_rank +
  qk_rope_head_dim)``, held where the K pool is held (``k_pool``, with no
  ``v_pool``), read by the latent decode kernel; its continuation chunks
  gather and up-project only the table entries their keys reach
  (``latent_rows_expanded`` counts those rows, each layer's once).
* **Contiguous.** Each slot owns a lane per layer, stored heads first:
  ``(L, max_batch, KH, W, dh)`` with ``W = min(cache_len,
  sliding_window)``, plus a hybrid model's conv tail and f32 SSM state per
  slot; an attention-free (SSM family) model's slots hold only its f32
  state and token shifts, no lanes. Prefill writes a slot's lane in
  place, decode reads and writes the active slots' lanes in place with
  the ring decode kernel (no per-step gather and scatter of whole lanes,
  as the reference's ``_decode_active`` had), and a lane wraps as a ring
  once a sequence outgrows W. Prefix caching keeps the reference's
  hash-keyed fragment store: per-block K/V copied out of a donor lane at
  prompt completion and into a hit's lane at admission
  (``prefix_tokens_copied`` counts the copied tokens), dropped through the
  allocator's eviction listener.

Admitted first chunks are grouped by length into one ``forward_seq`` per
power-of-two token bucket. Continuation chunks (chunked prefill, or the
suffix after a prefix-cache hit; attention-only models) run
``forward_chunk`` at per-row offsets, grouped by chunk length. A chunk that
completes a prompt commits its sampled token as the request's first output.
Decode runs one ``decode_step`` over the decode-ready slots per step.

Padding lanes. The jitted reference pads every dispatch batch to a power
of two with lanes that replay lane 0, to bound its compiled shapes. Eager
PyTorch compiles nothing per shape, so the port pads prefill only where
the padding changes the result: an MoE model's first chunks. Their one
``forward_seq`` routes all lanes' tokens as one dispatch, and expert
capacity couples the rows, so the replayed lanes run through the whole
model as in the reference (and make its group size divide the dispatch).
Only the real lanes' K/V and sampled tokens are kept: lane 0 keeps its
own values, where the reference's scatter lets its replica's overwrite
them (ROADMAP C3). ``forward_chunk`` and ``decode_step`` route each row
on its own, as the reference's continuation and decode programs do under
``vmap``, so padding them changes no real row; dense and VLM rows are
independent.

Captured steps. A served step is a few hundred small launches, and the
host issues them slower than the card runs them. So a paged backend keeps
one :class:`CapturedStep` per shape that a step can take, each over static
inputs of its own, and ``warmup`` on a CUDA device captures each as a CUDA
graph. Two kinds: ``decode_step`` per batch bucket (:func:`decode_buckets`),
and an MoE model's first-chunk ``forward_seq`` per (lanes, tokens) shape of
:func:`prefill_grid` (with a prefill budget, a first chunk is a whole
bucketed prompt or the budget itself, its lanes a power of two that fits
the budget). Every paged decode step, and every first-chunk group on the
grid, stages its rows into its shape's inputs, padded with rows that own
nothing (the all-null table, at position 0 for decode: their K/V lands in
the null block, whose reads are masked), and runs the step: a replay once
captured, the step itself on the CPU or before ``warmup``. The step
returns the logits, each position's MoE drops and, for a model that holds
a share of the experts, each position's slots routed to them; sampling
and the counts stay outside. Contiguous lanes, continuation chunks, first
chunks off the grid and the other families run eagerly, unpadded.

Prompt handling and completion length follow the reference: prompts are
hash-tokenized into their bucket, and a request finishes after its
ground-truth ``true_length`` tokens (the forced-length protocol).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import AUDIO, MOE, ModelConfig
from repro_torch.configs.latent import dense_layers, experts_held, is_latent
from repro_torch.core.predictor.tokenizer import HashTokenizer
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ops import (latent_decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_prefill.ops import flash_attention
from repro_torch.kernels.moe_route.ops import slot_positions
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import expert_rows, groups_of
from repro_torch.serving.config import ServingConfig, resolve_config
from repro_torch.serving.core import PrefillChunk, ServingCore, WallClock
from repro_torch.serving.kv_cache import (UNBOUNDED_BLOCKS, BlockAllocator,
                                          prefix_chunk_hashes)
from repro_torch.serving.metrics import LatencyReport, RunCounters, report
from repro_torch.serving.sampler import SamplerConfig, sample


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def prefill_grid(budget: Optional[int], buckets: Sequence[int],
                 max_batch: int) -> List[Tuple[int, int]]:
    """The (lanes, tokens) shapes of the MoE first-chunk dispatches that get
    a graph, largest first. A first chunk is a whole prompt of one of
    ``buckets`` up to the prefill ``budget``, or a longer prompt's first
    ``budget`` tokens; a step's first chunks hold at most ``budget``
    tokens, and a dispatch pads its lanes to a power of two. So the grid
    is every such length at every power of two of lanes (up to
    ``max_batch``) whose tokens fit the budget. Without a budget a step's
    chunks are bounded by nothing: no grid."""
    if not budget:
        return []
    widths = {w for w in buckets if w <= budget}
    if max(buckets) > budget:
        widths.add(budget)
    shapes = [(lanes, w) for w in widths
              for lanes in (1 << i for i in range(max_batch.bit_length()))
              if lanes <= max_batch and lanes * w <= budget]
    return sorted(shapes, key=lambda s: (s[0] * s[1], s[1]), reverse=True)


def decode_buckets(max_batch: int) -> List[int]:
    """The decode batch sizes that get a graph: 1, 2, 4, then every
    multiple of 8 below ``max_batch``, and ``max_batch``. A batch pads to
    the smallest bucket that holds it: past 4 rows by at most 7, where
    powers of two would pad 33 rows to 64."""
    return ([b for b in (1, 2, 4) if b < max_batch]
            + list(range(8, max_batch, 8)) + [max_batch])


class CapturedStep:
    """One shape of a served step that a CUDA graph may replay: a decode
    bucket (``rows`` rows of one token) or a first-chunk grid shape
    (``rows`` lanes of ``width`` tokens). Its static inputs on the device
    are ``tokens`` and one int32 buffer of each row's first ``nb`` table
    entries, ``tables``, then ``cols`` columns of a value a row,
    ``columns`` (decode: the positions; first chunks: the prompt lengths
    and the slots), filled from pinned twins: ``host``, and
    ``host_tokens`` where the host gives the tokens (first chunks;
    decode's come from the device). ``forward(step)`` runs the step over
    the static inputs and returns ``(logits (rows, V), token_drops or
    None, token_held or None)``, calling the attention kernel once a layer
    and, for an MoE model, ``slot_positions`` once an MoE layer: the
    wrappers of ``kernels``, whose launch counts a replay advances."""

    def __init__(self, forward: Callable, kernels: Tuple, rows: int,
                 width: int, nb: int, cols: int, null: int,
                 device: torch.device, *, host_tokens: bool):
        pin = device.type == "cuda"
        self.forward, self.kernels = forward, kernels
        self.rows, self.nb, self.null = rows, nb, null
        self.host = torch.zeros(rows * (nb + cols), dtype=torch.int32,
                                pin_memory=pin)
        self.host[:rows * nb] = null              # every row a padding row
        self.meta = self.host.to(device, copy=True)
        self.tables = self.meta[:rows * nb].view(rows, nb)
        self.columns = self.meta[rows * nb:].view(cols, rows)
        self._host_tables = self.host[:rows * nb].view(rows, nb).numpy()
        self._host_columns = self.host[rows * nb:].view(cols, rows).numpy()
        self.tokens = torch.zeros(rows, width, dtype=torch.int64,
                                  device=device)
        self.host_tokens = (torch.zeros(rows, width, dtype=torch.int64,
                                        pin_memory=pin)
                            if host_tokens else None)
        self.sent = torch.cuda.Event() if pin else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[Tuple] = None     # the graph's static outputs
        self.calls = (0,) * len(kernels)     # its calls of each kernel

    def stage(self, tables: Sequence[Sequence[int]],
              cols: Sequence[Sequence[int]], tokens=None) -> None:
        """Fill the static inputs: the real rows' ``tables`` and columns
        ``cols`` (one sequence a column), then the padding rows' all-null
        tables and 0s, by one non-blocking copy of the pinned twin; then
        ``tokens``, the real rows' on the device, or every row's (lanes
        past the real rows replay lane 0) through their pinned twin. A
        twin is rewritten only after the copy that read it last has
        finished, as the event recorded after that copy tells: decode
        stages once a step and a bucketed prefill each shape once, each
        step ending in a synchronisation, but an unbucketed prefill stages
        its one ``(1, prompt_len)`` shape once a request."""
        if self.sent is not None:
            self.sent.synchronize()
        n = len(tables)
        for j, table in enumerate(tables):
            self._host_tables[j] = table
        self._host_tables[n:] = self.null
        self._host_columns[:, :n] = cols
        self._host_columns[:, n:] = 0
        self.meta.copy_(self.host, non_blocking=True)
        if tokens is not None:
            if self.host_tokens is not None:
                self.host_tokens.numpy()[:] = tokens
                tokens = self.host_tokens
            self.tokens[:len(tokens)].copy_(tokens, non_blocking=True)
        if self.sent is not None:
            self.sent.record()

    def capture(self, pool) -> None:
        """Capture the step on the current stream as a CUDA graph whose
        memory comes from ``pool``. The capture's kernel calls launch
        nothing, so their ``launches`` leave them out; each replay adds
        them."""
        graph = torch.cuda.CUDAGraph()
        before = [k.launches for k in self.kernels]
        graph.capture_begin(pool=pool)
        try:
            out = self.forward(self)
        finally:
            graph.capture_end()
        self.calls = tuple(k.launches - n
                           for k, n in zip(self.kernels, before))
        for k, n in zip(self.kernels, before):
            k.launches = n
        self.graph, self.out = graph, out

    def run(self) -> Tuple:
        """The step over the staged inputs: once captured, its graph's
        replay; else the step itself."""
        if self.graph is None:
            return self.forward(self)
        with trace.span("backend.replay"):
            self.graph.replay()
        for k, n in zip(self.kernels, self.calls):
            k.launches += n
        return self.out


class RealBackend:
    """Prefill/decode over a paged KV pool or per-slot lanes
    (ExecutionBackend)."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int,
                 cache_len: int = 512, prompt_len: int = 32,
                 tokenizer: Optional[HashTokenizer] = None,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 bucketed: bool = True, min_bucket: int = 8,
                 record_tokens: bool = False, paged: bool = True,
                 device: DeviceLike = "cuda"):
        tfm.check_supported(cfg)
        if cfg.family == AUDIO or cfg.is_encdec:
            raise NotImplementedError(
                f"{cfg.arch_id}: the engine does not serve the audio "
                f"family, as the reference's cannot: its prefill "
                f"(_prefill_bucket) calls forward_seq without frames, so "
                f"the encoder has nothing to read; run Whisper through "
                f"models.build(cfg).prefill(..., frames=...) and "
                f"decode_step")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.prompt_len = prompt_len
        self.bucketed = bucketed
        self.min_bucket = min(min_bucket, prompt_len)
        self.record_tokens = record_tokens
        self.paged = paged
        self.tok = tokenizer or HashTokenizer(
            vocab_size=min(cfg.vocab_size, 2048), max_len=prompt_len)
        self._sampler_cfg = sampler
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.core: Optional[ServingCore] = None

        # --- slot state ------------------------------------------------------
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self._slot_of: Dict[int, int] = {}
        self._ids: Dict[int, List[int]] = {}    # req_id -> encoded prompt ids
        # each slot's pending decode input (its last sampled token)
        self.slot_tokens = torch.zeros(max_batch, dtype=torch.int64,
                                       device=self.device)

        # --- contiguous lanes (paged=False): one per slot, heads first ------
        self.lanes: Optional[tfm.Cache] = (
            None if paged else tfm.init_cache(
                cfg, max_batch, cache_len, paged=False,
                dtype=params["embed"].dtype, device=self.device))
        # chunk-chain hash -> {"k", "v": (L, KH, block, dh)} K/V of one
        # content-named block, cloned out of a donor lane at prompt
        # completion (a view would change with the slot's next occupant);
        # dropped through the allocator's eviction listener. Paged mode has
        # no store: a hit aliases pool blocks into the new table.
        self._prefix_store: Dict[int, dict] = {}

        # --- paged KV pool (built at attach: sized by the core's allocator) --
        # a latent model's one pool of latent rows is k_pool, v_pool None
        self.latent = is_latent(cfg)
        self.k_pool: Optional[torch.Tensor] = None
        self.v_pool: Optional[torch.Tensor] = None
        self._null_block: Optional[int] = None
        self._lane_blocks: Optional[int] = None    # cache_len // block_size
        # the captured steps (built with the pool), each table largest
        # first: decode bucket -> its step; (lanes, tokens) -> an MoE
        # model's first-chunk step, with a prefill budget
        self._decode_shapes: Dict[int, CapturedStep] = {}
        self._first_shapes: Dict[Tuple[int, int], CapturedStep] = {}
        # req_id -> tokens resident in the request's lane: the prefill target
        # at prompt completion, +1 per decode step (recompute re-admissions
        # restart at the target)
        self._pos: Dict[int, int] = {}

        # --- instrumentation -------------------------------------------------
        self.prefill_dispatches = 0   # first-chunk forward_seq dispatches
        self.extend_dispatches = 0    # continuation-chunk dispatches
        self.prefill_requests = 0     # requests whose prefill completed
        self.prefill_seconds = 0.0    # wall time spent in admission/prefill
        self.decode_steps = 0         # decode_step dispatches
        self.decode_seconds = 0.0     # their wall time, timed as prefill's
        self.decode_graph_steps = 0   # decode steps served by a graph replay
        self.decode_pad_rows = 0      # padding rows the decode steps ran
        # MoE expert rows the dispatches' products ran and the real
        # positions' slots routed to them, summed over MoE layers; of those
        # slots, the ones whose expert this chip holds (a device sum where
        # the model holds a share: read as an int by ``held_slots``)
        self.expert_rows = 0
        self.routed_slots = 0
        self._held = 0
        self.prefill_graph_dispatches = 0  # first chunks served by a replay
        self.capture_seconds = 0.0    # wall time of warmup's captures
        self.prefill_capture_seconds = 0.0  # the first-chunk graphs' part
        self.prefix_installs = 0      # slots claimed at a cached offset
        self.prefix_tokens_copied = 0  # KV tokens copied instead of computed
        self.prefill_pad_lanes = 0    # replayed lanes of MoE first chunks
        # latent rows of the pool that continuation chunks up-projected,
        # summed over layers
        self.latent_rows_expanded = 0
        # MoE token-slots of real positions dropped at expert capacity,
        # summed on the device: read as an int by ``dropped_slots``
        self._dropped = 0

    # -------------------------------------------------------------- protocol
    def attach(self, core: ServingCore) -> None:
        self.core = core
        cfg = self.cfg
        if core.prefill_chunk_tokens is not None or core.prefix_caching:
            # both features continue prefill at non-zero offsets (a cache
            # hit resumes mid-prompt even with chunking off), so both need
            # exact attention-only continuation
            if cfg.family not in tfm.ATTENTION_FAMILIES or cfg.is_encdec:
                raise ValueError(
                    f"chunked prefill / prefix caching needs an "
                    f"attention-family model (got {cfg.family}): "
                    f"recurrent families carry cross-chunk state "
                    f"forward_seq does not externalize")
            if cfg.sliding_window or self.prompt_len > self.cache_len:
                raise ValueError(
                    "chunked prefill / prefix caching needs an append-buffer "
                    "cache covering the whole prompt (prompt_len <= "
                    "cache_len, no sliding window): continuation chunks "
                    "write at absolute offsets")
        if (core.prefill_chunk_tokens is not None
                and core.prefill_chunk_tokens > self.cache_len):
            raise ValueError(
                f"prefill_chunk_tokens={core.prefill_chunk_tokens} "
                f"exceeds cache_len={self.cache_len}: a continuation "
                f"chunk must fit the cache lane it extends")
        if not self.paged:
            if core.prefix_caching:
                # keep the fragment store in lockstep with the accounting:
                # when the allocator reclaims a cached block, its KV goes too
                core.allocator.add_evict_listener(
                    lambda h: self._prefix_store.pop(h, None))
            return
        if not tfm.default_paged(cfg):
            raise ValueError(
                f"paged KV needs an attention-family model without a "
                f"sliding window (got {cfg.family}, window "
                f"{cfg.sliding_window}): recurrent state is not "
                f"block-structured and window lanes are shorter than the "
                f"positions they cover")
        alloc = core.allocator
        if alloc.total_blocks >= UNBOUNDED_BLOCKS:
            raise ValueError("paged KV needs a bounded allocator: the "
                             "pool is materialized at total_blocks")
        if self.cache_len % alloc.block_size or \
                self.cache_len < alloc.block_size:
            raise ValueError(
                f"paged KV needs block_size | cache_len "
                f"(got {alloc.block_size} and {self.cache_len})")
        self._build_paged(alloc)

    def _build_paged(self, alloc: BlockAllocator) -> None:
        """Materialize the global KV pools: ``(L, total_blocks + 1,
        block_size, KH, dh)`` each, or the one latent pool ``(L,
        total_blocks + 1, block_size, latent_dim)``; block N the null
        block."""
        cfg = self.cfg
        n = alloc.total_blocks
        self._null_block = n
        self._lane_blocks = self.cache_len // alloc.block_size
        dtype = self.params["embed"].dtype
        if self.latent:
            self.k_pool = torch.zeros(cfg.num_layers, n + 1, alloc.block_size,
                                      cfg.latent_dim, dtype=dtype,
                                      device=self.device)
        else:
            shape = (cfg.num_layers, n + 1, alloc.block_size,
                     cfg.num_kv_heads, cfg.head_dim)
            self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
            self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        decode_kernel = (latent_decode_attention if self.latent
                         else paged_decode_attention)
        self._decode_shapes = {
            b: CapturedStep(self._decode_forward,
                            (decode_kernel, slot_positions), b, 1,
                            self._lane_blocks, 1, self._null_block,
                            self.device, host_tokens=False)
            for b in reversed(decode_buckets(self.max_batch))}
        if cfg.family != MOE:
            return
        for lanes, width in prefill_grid(self.core.prefill_chunk_tokens,
                                         self.bucket_lens(), self.max_batch):
            self._first_shapes[lanes, width] = CapturedStep(
                self._first_forward, (flash_attention, slot_positions),
                lanes, width, -(-width // alloc.block_size), 2,
                self._null_block, self.device, host_tokens=True)

    def _pools(self) -> tfm.Cache:
        """The pools as a paged cache holds them."""
        if self.latent:
            return {"latent": self.k_pool}
        return {"k": self.k_pool, "v": self.v_pool}

    def _decode_forward(self, step: CapturedStep):
        """``decode_step`` over a decode bucket's static inputs."""
        logits, _, aux = tfm.decode_step(
            self.params, self.cfg, {**self._pools(), "pos": step.columns[0],
                                    "tables": step.tables}, step.tokens)
        return logits, aux.get("token_drops"), aux.get("token_held")

    def _first_forward(self, step: CapturedStep):
        """``forward_seq`` over a first-chunk shape's static inputs, the
        last position's logits (a copy: the graph keeps no others)."""
        logits, _, aux = tfm.forward_seq(
            self.params, self.cfg, step.tokens,
            cache={**self._pools(), "tables": step.tables})
        return logits[:, -1].clone(), aux["token_drops"], aux.get("token_held")

    def _capture(self) -> None:
        """A CUDA graph of every captured step, the first-chunk shapes then
        the decode buckets, each kind largest first, all on one side
        stream in one private memory pool (so that each capture reuses
        the memory the one before it freed): the graphs run one at a time,
        and each one's outputs are read before the next replay. The
        largest of each kind runs once eagerly before its kind's captures
        (the lazy initialisations a capture cannot hold); the other shapes
        need no pass of their own. The captures go straight to the graph,
        without the collection, the synchronisation and the emptied caches
        that ``torch.cuda.graph`` adds to each. No garbage collection runs
        during them: one could destroy a dead engine's graphs, which a
        capture does not permit."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        pool = torch.cuda.graph_pool_handle()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                t0 = time.perf_counter()
                for shapes in (self._first_shapes, self._decode_shapes):
                    steps = list(shapes.values())
                    if steps:
                        steps[0].forward(steps[0])
                        side.synchronize()
                    for step in steps:
                        step.capture(pool)
                    if shapes is self._first_shapes:
                        self.prefill_capture_seconds = (time.perf_counter()
                                                        - t0)
        finally:
            if collecting:
                gc.enable()
        main.wait_stream(side)

    def _table(self, req: Request, n: int) -> List[int]:
        """First ``n`` entries of the request's block table, null-padded.
        Unreserved requests (direct backend calls in unit tests) get an
        all-null table: their KV lands in the null block, whose reads are
        masked."""
        tbl = (self.core.allocator.block_table(req.req_id)[:n]
               if self.core is not None else [])
        return tbl + [self._null_block] * (n - len(tbl))

    def _cache(self, reqs: Sequence[Request], pos: Sequence[int],
               n_blocks: Optional[int] = None) -> tfm.Cache:
        """The model's view of the KV for one dispatch over ``reqs`` at
        per-row positions ``pos``: the pool with the requests' first
        ``n_blocks`` table entries (default: whole lanes), or the lanes with
        the requests' slots."""
        pos_t = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        if not self.paged:
            slots = [self._slot_of[r.req_id] for r in reqs]
            return {**self.lanes, "pos": pos_t,
                    "slots": torch.as_tensor(slots, dtype=torch.int32,
                                             device=self.device)}
        n = n_blocks or self._lane_blocks
        tables = np.asarray([self._table(r, n) for r in reqs], np.int32)
        return {**self._pools(), "pos": pos_t,
                "tables": torch.as_tensor(tables, dtype=torch.int32,
                                          device=self.device)}

    def kv_demand(self, req: Request) -> int:
        return self.prompt_len + min(req.true_length, self.cache_len)

    def prefix_tokens(self, req: Request) -> List[int]:
        """Prefix-sharing stream = the encoded *real* prompt ids (bucket
        padding is excluded: pad KV depends on where padding starts, so only
        whole blocks of real tokens are content-addressable)."""
        return self._prompt_ids(req)

    def prefill_total(self, req: Request) -> int:
        """Prompt tokens this engine actually prefills for ``req``: its
        hash-tokenized prompt padded up to the power-of-two bucket (or to
        ``prompt_len`` when bucketing is off). Chunk planning, the
        decode-ready check, and the first-output-token position all use this
        padded length, so chunked runs process the exact token stream the
        unchunked bucket path does."""
        return self._bucket_len(len(self._prompt_ids(req)))

    def _prompt_ids(self, req: Request) -> List[int]:
        """Encode (and cache) a prompt's token ids, truncated to
        ``prompt_len``; dropped on ``release``."""
        ids = self._ids.get(req.req_id)
        if ids is None:
            ids = [t % self.cfg.vocab_size
                   for t in self.tok.encode(req.prompt)[:self.prompt_len]]
            self._ids[req.req_id] = ids
        return ids

    def _bucket_len(self, n_tokens: int) -> int:
        """Power-of-two token bucket for an ``n_tokens``-long prompt, clamped
        to [min_bucket, prompt_len]; unbucketed mode pads everything to
        ``prompt_len``."""
        if not self.bucketed:
            return self.prompt_len
        return min(self.prompt_len, _next_pow2(max(n_tokens, self.min_bucket)))

    def bucket_lens(self) -> List[int]:
        if not self.bucketed:
            return [self.prompt_len]
        lens, b = [], self.min_bucket
        while b < self.prompt_len:
            lens.append(b)
            b *= 2
        return lens + [self.prompt_len]

    def warmup(self) -> float:
        """Build the CUDA kernels ahead of serving and, over a paged pool,
        capture the first-chunk and decode graphs (nothing to do on the
        CPU: eager PyTorch compiles no per-shape programs). Call it before
        serving, never while a profiler records. Returns wall seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            build.build_all()
            if self._decode_shapes and \
                    self._decode_shapes[self.max_batch].graph is None:
                t1 = time.perf_counter()
                self._capture()
                self.capture_seconds = time.perf_counter() - t1
        return time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _now(self, fallback: float) -> float:
        return self.core.clock.now() if self.core is not None else fallback

    def _record(self, req: Request, token, now: float) -> None:
        if self.record_tokens:
            req.generated_tokens.append(int(token))
        if self.core is not None and self.core.record_token_times:
            req.token_times.append(now)

    def _tokens_snapshot(self) -> Optional[List[int]]:
        """One host copy of ``slot_tokens`` for ``_record``; None when
        neither recording flag is on (skip the device-to-host transfer)."""
        if self.record_tokens or (self.core is not None
                                  and self.core.record_token_times):
            return self.slot_tokens.tolist()
        return None

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self._gen, self._sampler_cfg)

    def _real(self, counts: torch.Tensor, n: int, lengths=None):
        """The sum of a dispatch's per-position ``counts`` (B, S) at its
        real positions: those of its first ``n`` rows (a replayed lane is
        none of them) that lie before each row's length in ``lengths``,
        where given (every position of a decode step is real)."""
        counts = counts[:n]
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device)
            counts = counts * (torch.arange(counts.shape[1],
                                            device=self.device)
                               < lengths[:, None])
        return counts.sum()

    def _count_drops(self, drops: Optional[torch.Tensor], n: int,
                     lengths=None) -> None:
        """Add a dispatch's MoE capacity drops (``token_drops``, None for
        the other families) at its real positions (:meth:`_real`)."""
        if drops is not None:
            self._dropped = self._dropped + self._real(drops, n, lengths)

    def _count_rows(self, b: int, s: int, per_row: bool, real: int,
                    held: Optional[torch.Tensor] = None, n: int = 0,
                    lengths=None) -> None:
        """Add an MoE dispatch of ``b`` rows of ``s`` tokens (padding
        included) to ``expert_rows``, and ``real`` positions' slots to
        ``routed_slots``, in every MoE layer: counted from the shape on the
        host, since a replay runs no Python. Its slots routed to a held
        expert go to ``held_slots``: every routed slot where the model
        holds every expert, else the real positions' ``token_held``
        (:meth:`_real` of ``n`` and ``lengths``), summed on the device."""
        moe = self.cfg.moe
        if moe is None:
            return
        layers = self.cfg.num_layers - dense_layers(self.cfg)
        self.expert_rows += layers * expert_rows(
            *groups_of(b, s, moe, per_row), moe, experts_held(self.cfg))
        self.routed_slots += layers * moe.top_k * real
        self._held = self._held + (layers * moe.top_k * real if held is None
                                   else self._real(held, n, lengths))

    @property
    def dropped_slots(self) -> int:
        """MoE token-slots of real prompt and output positions dropped at
        expert capacity so far (pad positions' drops left out; reading it
        waits for the device)."""
        return int(self._dropped)

    @property
    def held_slots(self) -> int:
        """Of ``routed_slots``, those whose expert this chip holds, drops
        included (reading it waits for the device where the model holds a
        share of the experts): over ``routed_slots``, the share of the
        routing that lands here."""
        return int(self._held)

    # ------------------------------------------------------- prefix caching
    def _store_prefix(self, req: Request) -> None:
        """Contiguous mode: clone the completed prompt's content-named
        per-block K/V out of its lane into the fragment store (skipping
        blocks already stored by an earlier identical prefix, and blocks the
        allocator does not track, e.g. past the hit cap)."""
        core = self.core
        if core is None or not core.prefix_caching:
            return
        bs = core.allocator.block_size
        slot = self._slot_of[req.req_id]
        for i, h in enumerate(prefix_chunk_hashes(self._prompt_ids(req), bs)):
            if h in self._prefix_store or not core.allocator.tracked(h):
                continue
            rows = slice(i * bs, (i + 1) * bs)
            self._prefix_store[h] = {
                "k": self.lanes["k"][:, slot, :, rows].clone(),
                "v": self.lanes["v"][:, slot, :, rows].clone()}

    def _install_prefix(self, slot: int, req: Request, n_tokens: int) -> None:
        """Contiguous mode: seed a freshly claimed lane with a cached prefix,
        the hit chain's fragments at positions ``[0, n_tokens)``; prefill
        then resumes at the cached offset. The blocks are refcount-pinned by
        this request's reservation, so every fragment is present
        (commit-before-hit and the eviction listener)."""
        bs = self.core.allocator.block_size
        hashes = prefix_chunk_hashes(self._prompt_ids(req), bs)
        frags = [self._prefix_store[h] for h in hashes[:n_tokens // bs]]
        self.lanes["k"][:, slot, :, :n_tokens] = torch.cat(
            [f["k"] for f in frags], dim=2)
        self.lanes["v"][:, slot, :, :n_tokens] = torch.cat(
            [f["v"] for f in frags], dim=2)
        self.prefix_installs += 1
        self.prefix_tokens_copied += n_tokens

    def prefill(self, chunks: Sequence[PrefillChunk], now: float) -> float:
        """Execute one step's planned prefill chunks (see ``ServingCore``).

        First chunks (``start == 0``) claim a free slot and run one bucketed
        ``forward_seq`` per chunk length. A prefix-cache hit's first chunk
        arrives with ``start > 0``: it claims a slot (paged: its table
        already aliases the cached blocks; contiguous: the fragment store
        seeds its lane) and runs as a continuation. Continuation chunks run
        ``forward_chunk`` grouped by length; requests at different offsets
        share a dispatch. A request whose chunk reaches ``prefill_total``
        gets its first output token committed (tokens_done and TTFT
        bookkeeping preserved across preemption re-admission) and, in
        contiguous mode, its prefix blocks' KV stored for later hits."""
        if not chunks:
            return now
        with trace.span("backend.prefill"):
            trace.ids(r for r, _s, _e in chunks)
            return self._prefill(chunks, now)

    def _prefill(self, chunks: Sequence[PrefillChunk], now: float) -> float:
        t0 = time.perf_counter()
        first_groups: Dict[int, list] = {}
        ext_groups: Dict[int, list] = {}
        for req, start, end in chunks:
            if req.req_id not in self._slot_of:
                slot = self.slot_req.index(None)
                self.slot_req[slot] = req
                self._slot_of[req.req_id] = slot
                if self.paged and self.core is not None \
                        and self.core.prefix_caching \
                        and self.prefill_total(req) + req.true_length - 1 \
                        > self.cache_len:
                    raise ValueError(
                        f"paged KV with prefix caching cannot ring-wrap: "
                        f"request {req.req_id} needs "
                        f"{self.prefill_total(req) + req.true_length - 1} "
                        f"positions > cache_len={self.cache_len} (a wrap "
                        f"would overwrite potentially shared prefix blocks)")
                if start > 0:               # admission at a cached offset
                    if self.paged:
                        # zero-copy hit: the reservation already aliased the
                        # shared prefix blocks into this request's table
                        self.prefix_installs += 1
                    else:
                        self._install_prefix(slot, req, start)
            if start == 0:
                first_groups.setdefault(end, []).append(req)
            else:
                ext_groups.setdefault(end - start, []).append((req, start, end))

        if self.bucketed:
            first_batches = sorted(first_groups.items())
        else:                          # sequential: one dispatch per request
            first_batches = [(ln, [r]) for ln, g in sorted(first_groups.items())
                             for r in g]
        for bucket_len, group in first_batches:
            n = len(group)
            # an MoE dispatch replays lane 0 up to a power of two (see the
            # module docstring); the cache takes the first n rows only
            lanes = _next_pow2(n) if self.cfg.family == MOE else n
            step = self._first_shapes.get((lanes, bucket_len))
            with trace.span("backend.tables"):
                tokens = np.zeros((lanes, bucket_len), np.int64)
                lengths = []
                for j, req in enumerate(group):
                    ids = self._prompt_ids(req)[:bucket_len]
                    tokens[j, :len(ids)] = ids      # tail = pad token 0
                    lengths.append(len(ids))
                tokens[n:] = tokens[0]
                real = sum(lengths)
                slots = [self._slot_of[r.req_id] for r in group]
                if step is not None:
                    step.stage([self._table(r, step.nb) for r in group],
                               [lengths, slots], tokens)
                    lengths, slots = step.columns[:, :n]
                    slots = slots.long()
                else:
                    # the pool blocks that hold the bucket
                    nb = (-(-bucket_len // self.k_pool.shape[2])
                          if self.paged else None)
                    tokens = torch.as_tensor(tokens, device=self.device)
                    cache = self._cache(group, np.zeros(n, np.int32), nb)
            if step is not None:
                logits, drops, held = step.run()
                self.prefill_graph_dispatches += step.graph is not None
            else:
                logits, _, aux = tfm.forward_seq(self.params, self.cfg,
                                                 tokens, cache=cache)
                logits, drops, held = (logits[:, -1], aux.get("token_drops"),
                                       aux.get("token_held"))
            self._count_drops(drops, n, lengths)
            self._count_rows(lanes, bucket_len, False, real, held, n, lengths)
            with trace.span("backend.sample"):
                self.slot_tokens[slots] = self._sample(logits[:n])
            self.prefill_dispatches += 1
            self.prefill_pad_lanes += lanes - n

        for chunk_len, group in sorted(ext_groups.items()):
            with trace.span("backend.tables"):
                tokens = np.zeros((len(group), chunk_len), np.int64)
                starts = np.zeros((len(group),), np.int32)
                commit, lengths = [], []
                for j, (req, start, end) in enumerate(group):
                    ids = self._prompt_ids(req)[start:end]
                    tokens[j, :len(ids)] = ids  # tail past len(ids) = pad 0s
                    starts[j] = start
                    commit.append(end >= self.prefill_total(req))
                    lengths.append(len(ids))
                tokens = torch.as_tensor(tokens, device=self.device)
                # a latent lane is up-projected whole: gather only the
                # entries the chunks' keys reach
                nb = (-(-(int(starts.max()) + chunk_len)
                        // self.k_pool.shape[2]) if self.latent else None)
                cache = self._cache([r for r, _s, _e in group], starts, nb)
                if self.latent:
                    self.latent_rows_expanded += (len(group) * nb
                                                  * self.k_pool.shape[2]
                                                  * self.cfg.num_layers)
            logits, _, aux = tfm.forward_chunk(self.params, self.cfg, tokens,
                                               cache)
            self._count_drops(aux.get("token_drops"), len(group), lengths)
            self._count_rows(len(group), chunk_len, True, sum(lengths),
                             aux.get("token_held"), len(group), lengths)
            with trace.span("backend.sample"):
                nxt = self._sample(logits[:, -1])
                # mid-prompt samples are meaningless: only completing chunks
                # commit a pending decode token
                rows = [j for j, c in enumerate(commit) if c]
                if rows:
                    slots = [self._slot_of[group[j][0].req_id] for j in rows]
                    self.slot_tokens[slots] = nxt[rows]
            self.extend_dispatches += 1

        with trace.span("backend.sync"):
            self._sync()
        self.prefill_seconds += time.perf_counter() - t0
        with trace.span("backend.record"):
            now = self._now(now)
            toks = self._tokens_snapshot()
            for req, _start, end in chunks:
                if end < self.prefill_total(req):
                    continue                        # still mid-prompt
                self.prefill_requests += 1
                # start the host mirror of the lane pos; paged, the pool
                # blocks *are* the citable KV (the core commits their
                # hashes), contiguous, the prompt's blocks go to the fragment
                # store
                self._pos[req.req_id] = self.prefill_total(req)
                if not self.paged:
                    self._store_prefix(req)
                # recompute semantics on re-admission after preemption:
                # decode progress and TTFT are preserved
                if req.tokens_done == 0:
                    req.tokens_done = 1             # prefill emits token 1
                    if toks is not None:
                        self._record(req, toks[self._slot_of[req.req_id]],
                                     now)
                if req.first_token_time is None:
                    req.first_token_time = now
        return now

    def decode(self, now: float) -> float:
        with trace.span("backend.decode"):
            return self._decode(now)

    def _decode(self, now: float) -> float:
        ready = (self.core.decode_ready if self.core is not None
                 else lambda r: True)
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and ready(r)]
        if not active:
            return now
        t0 = time.perf_counter()
        reqs = [self.slot_req[i] for i in active]
        trace.ids(reqs)
        n = len(reqs)
        with trace.span("backend.tables"):
            tokens = self.slot_tokens[active][:, None]
            poss = [self._pos[r.req_id] for r in reqs]
            if self.paged:      # the smallest bucket that holds the rows
                step = self._decode_shapes[min(b for b in self._decode_shapes
                                               if b >= n)]
                step.stage([self._table(r, step.nb) for r in reqs], [poss],
                           tokens)
            else:
                cache = self._cache(reqs, poss)
        if self.paged:
            logits, drops, held = step.run()
            self.decode_graph_steps += step.graph is not None
            self.decode_pad_rows += step.rows - n
        else:
            logits, _, aux = tfm.decode_step(self.params, self.cfg, cache,
                                             tokens)
            drops, held = aux.get("token_drops"), aux.get("token_held")
        self._count_drops(drops, n)
        self._count_rows(step.rows if self.paged else n, 1, True, n, held, n)
        with trace.span("backend.sample"):
            self.slot_tokens[active] = self._sample(logits[:n])
        with trace.span("backend.sync"):
            self._sync()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        with trace.span("backend.record"):
            now = self._now(now)
            toks = self._tokens_snapshot()
            for i, req in zip(active, reqs):
                req.tokens_done += 1
                self._pos[req.req_id] += 1
                if toks is not None:
                    self._record(req, toks[i], now)
        return now

    def release(self, req: Request) -> None:
        self._ids.pop(req.req_id, None)
        self._pos.pop(req.req_id, None)
        slot = self._slot_of.pop(req.req_id, None)
        if slot is not None:
            self.slot_req[slot] = None


class TracedCore(ServingCore):
    """The copied :class:`ServingCore` with the tracer's spans around each
    run-loop iteration (``core.tick``) and serving step (``core.step``,
    carrying the ids of the requests it admitted)."""

    def tick(self, *, on_step=None):
        with trace.span("core.tick"):
            return super().tick(on_step=on_step)

    def step(self, now: float) -> float:
        with trace.span("core.step"):
            if not trace.enabled():
                return super().step(now)
            waiting = list(self.scheduler.waiting)
            out = super().step(now)
            trace.ids(r for r in waiting if r.start_time == now)
            return out


class Engine:
    """RealBackend + ServingCore wiring (the reference's engine interface)."""

    def __init__(self, cfg: ModelConfig, params, scheduler: Scheduler, *,
                 cache_len: int = 512, prompt_len: int = 32,
                 tokenizer: Optional[HashTokenizer] = None,
                 allocator: Optional[BlockAllocator] = None,
                 sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
                 bucketed: bool = True,
                 paged: Optional[bool] = None,
                 record_tokens: bool = False,
                 config: Optional[ServingConfig] = None,
                 device: DeviceLike = "cuda",
                 **core_kw):
        if paged is None:
            # auto, as the reference: block-structured KV for
            # attention-only append caches, per-slot lanes otherwise
            paged = tfm.default_paged(cfg)
        config = resolve_config(config, core_kw)
        s = scheduler.max_batch
        self.scheduler = scheduler
        self.backend = RealBackend(
            cfg, params, max_batch=s, cache_len=cache_len,
            prompt_len=prompt_len, tokenizer=tokenizer, sampler=sampler,
            seed=seed, bucketed=bucketed, record_tokens=record_tokens,
            paged=paged, device=device)
        self.allocator = allocator or BlockAllocator(
            total_blocks=s * (-(-cache_len // 16)), block_size=16)
        self.core = TracedCore(scheduler, self.backend,
                               allocator=self.allocator, config=config)

    # -------------------------------------------------------------------- api
    @property
    def finished(self) -> List[Request]:
        return self.core.finished

    def submit(self, requests: Sequence[Request]) -> None:
        self.core.submit(requests)

    def warmup(self) -> float:
        return self.backend.warmup()

    def run(self, *, time_scale: float = 1.0, log_every: float = 0.0,
            log_fn=print) -> List[Request]:
        """Serve everything submitted; returns finished requests.

        ``time_scale`` multiplies trace arrival times."""
        if time_scale != 1.0:
            for r in self.core._pending:
                r.arrival_time *= time_scale
        self.core.clock = WallClock()           # origin = serving start
        return self.core.run(log_every=log_every, log_fn=log_fn)


def serve(cfg: ModelConfig, params, requests: Sequence[Request], policy, *,
          max_batch: int = 8, cache_len: int = 256, prompt_len: int = 32,
          starvation_threshold: float = 120.0, time_scale: float = 1.0,
          log_every: float = 0.0, bucketed: bool = True,
          kv_blocks: Optional[int] = None,
          paged: Optional[bool] = None,
          config: Optional[ServingConfig] = None,
          device: DeviceLike = "cuda",
          **core_kw) -> LatencyReport:
    """Convenience wrapper: fresh engine + scheduler, serve, report. Core
    behaviour comes from ``config`` or loose keywords (chunking, caching,
    reservation mode, re-ranking, deadlines, shedding, ...); dropped
    requests are counted in the report, never silently lost."""
    config = resolve_config(config, core_kw)
    sched = Scheduler(policy=policy, max_batch=max_batch,
                      starvation_threshold=starvation_threshold)
    allocator = BlockAllocator(kv_blocks, 16) if kv_blocks else None
    eng = Engine(cfg, params, sched, cache_len=cache_len,
                 prompt_len=prompt_len, allocator=allocator,
                 bucketed=bucketed, paged=paged, config=config,
                 device=device)
    eng.submit(requests)
    finished = eng.run(time_scale=time_scale, log_every=log_every)
    dropped = eng.core.dropped
    if len(finished) + len(dropped) != len(requests):
        raise RuntimeError(f"requests lost: {len(finished)} finished + "
                           f"{len(dropped)} dropped != {len(requests)}")
    return report(policy.name, finished,
                  counters=RunCounters(
                      reranks=(eng.core.rerank_count
                               if config.rerank_enabled else None),
                      dropped=tuple(dropped) if dropped else None))
