"""Batched serving engine: continuous batching over a fixed-slot KV cache.

The engine keeps `slots` concurrent sequences. Each scheduler tick:
  1. admit queued requests into free slots (prompt tokens are injected
     through the decode path token by token — teacher-forced prefill — so
     one decode_step serves both phases);
  2. run one batched decode_step for ALL slots, idle ones included;
  3. retire sequences that hit max tokens or EOS.

Greedy or temperature sampling, on the host: every tick copies the
(slots, V) logits off the device, as the JAX engine does.

The engine runs where its model lives: a model built with ``device=None`` is
on the GPU. The caches are updated in place by ``Model.decode_step`` and by
``_reset_slot``.

As the reference's engine, it feeds the vlm family all-zero float32
``media`` and the audio family an all-zero float32 ``enc_out`` of `slots`
rows at every tick (``_extras``); here they are made once, on the model's
device and in its compute dtype, since they hold the same values every tick
(``Model._extra`` then casts nothing).

`AllocationEndpoint` exposes the allocator subsystem
(repro_torch.allocator.service) on the same serving surface: dict-in/dict-out
allocation requests, optionally attached to a `ServeEngine` via
`attach_allocator` so one server answers both generation and
resource-allocation traffic. An allocation answered from the card
(``core.hbm_planner.gpu_profile_fn``) runs steps on the engine's device on
the service's worker thread: see `AllocationEndpoint`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.allocator.service import (AllocationRequest,
                                           AllocationResponse,
                                           AllocationService)
from repro_torch.models.model import Model
from repro_torch.telemetry import span_if


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = field(default_factory=time.monotonic)
    finished_at: Optional[float] = None


class ServeEngine:
    def __init__(self, model: Model, slots: int, max_len: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 allocator: Optional[AllocationService] = None):
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        # sampling happens on the host, from an explicit generator
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(seed)
        self.caches = model.init_caches(slots, max_len)
        self.active: List[Optional[Request]] = [None] * slots
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self.ticks = 0
        self._feed: List[List[int]] = [[] for _ in range(slots)]
        self._last_token = np.zeros((slots,), np.int64)
        self._extras = _extras(model, slots)
        self.allocation_endpoint: Optional[AllocationEndpoint] = None
        if allocator is not None:
            self.attach_allocator(allocator)

    # -- public ------------------------------------------------------------
    def submit(self, req: Request):
        self.pending.append(req)

    def attach_allocator(self,
                         service: AllocationService) -> "AllocationEndpoint":
        """Expose an AllocationService next to the generation loop."""
        self.allocation_endpoint = AllocationEndpoint(service)
        return self.allocation_endpoint

    def allocate(self, **payload) -> Dict:
        """Answer one allocation request (see AllocationEndpoint.handle)."""
        if self.allocation_endpoint is None:
            raise RuntimeError("no AllocationService attached; call "
                               "attach_allocator() first")
        return self.allocation_endpoint.handle(**payload)

    def run(self, max_ticks: int = 10000) -> List[Request]:
        ticks = 0
        while (self.pending or any(self.active)) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished

    # -- internals ----------------------------------------------------------
    def tick(self):
        self._admit()
        if not any(self.active):
            return
        batch = {"tokens": torch.from_numpy(self._last_token)[:, None],
                 **self._extras}
        logits, self.caches = self.model.decode_step(batch, self.caches)
        logits = logits[:, 0].float().cpu()           # (slots, V), a sync
        self.ticks += 1
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if self._feed[i]:
                # still teacher-forcing the prompt
                self._last_token[i] = self._feed[i].pop(0)
                continue
            tok = self._sample(logits[i], req.temperature)
            req.out_tokens.append(tok)
            self._last_token[i] = tok
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id)):
                req.done = True
                req.finished_at = time.monotonic()
                self.finished.append(req)
                self.active[i] = None

    def _admit(self):
        for i in range(self.slots):
            if self.active[i] is None and self.pending:
                req = self.pending.pop(0)
                self.active[i] = req
                self.caches = _reset_slot(self.caches, i)
                self._feed[i] = list(req.prompt[1:])
                self._last_token[i] = req.prompt[0]

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        if temperature <= 0.0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.generator))


def _extras(model: Model, slots: int) -> Dict[str, torch.Tensor]:
    """The reference's stand-ins for a request's media or audio: zeros."""
    cfg = model.cfg
    if cfg.family == "vlm":
        rows = cfg.cross_attn.n_media_tokens
        name = "media"
    elif cfg.family == "audio":
        rows = cfg.encdec.enc_len
        name = "enc_out"
    else:
        return {}
    return {name: torch.zeros((slots, rows, cfg.d_model),
                              dtype=model.compute_dtype, device=model.device)}


class AllocationEndpoint:
    """Request endpoint over an AllocationService: wire-friendly dicts in,
    dicts out, with the service's batching/caching behind it. `submit`
    returns the service future for async callers; `handle` blocks (pass
    `include_trace=True` for per-stage walls + acquisition-tier counts);
    `stats` reports service counters plus adaptive-profiling/budget state
    for monitoring dashboards; `metrics` is the full telemetry snapshot
    (histogram percentiles included).

    Tracing: `handle` runs inside an `endpoint.request` span (when the
    service's telemetry is enabled, or always when the caller passes its
    own `trace=` propagation token to join an upstream trace), so the
    worker-side `service.*` spans, the pipeline stages, and any daemon
    round-trips all land under ONE trace id — returned on the wire as
    `trace_id` (None when untraced) for correlation with
    `stitch_fleet_traces` output and histogram exemplars.

    A request whose `profile_at` runs steps on the card
    (``core.hbm_planner.gpu_profile_fn``) is profiled on the service's
    worker thread by ``CUDAMemoryProfiler``, which reads the process's peak
    of allocated bytes and refuses a job that leaves bytes allocated. The
    engine's resident weights and caches do not disturb it; an engine that
    ticks meanwhile does (a wrong reading, or a refusal). The caller keeps
    the two apart: no `tick()` while such a request is unanswered. The
    JAX package needs no such rule: its profile is a compile that touches
    no device memory."""

    def __init__(self, service: AllocationService):
        self.service = service

    def submit(self, *, job: str, profile_at, full_size: float,
               anchor: Optional[float] = None,
               sizes: Optional[List[float]] = None,
               signature: Optional[str] = None,
               leeway: Optional[float] = None,
               adaptive: Optional[bool] = None,
               placement: Optional[str] = None,
               tags: Optional[List[str]] = None,
               objective: str = "cheapest_fit"):
        return self.service.submit(AllocationRequest(
            job, profile_at, full_size, anchor=anchor, sizes=sizes,
            signature=signature, leeway=leeway, adaptive=adaptive,
            placement=placement, tags=tags, objective=objective))

    def handle(self, timeout: Optional[float] = None,
               include_trace: bool = False,
               trace: Optional[Dict] = None, **payload) -> Dict:
        # the span must wrap submit(): the service captures the caller's
        # trace context at submit time to hand it across the worker-
        # thread boundary. `trace=` is an upstream propagation token
        # ({"trace_id", "span_id"}) for callers that are themselves part
        # of a larger trace.
        tel = self.service.telemetry
        with span_if(tel.enabled or trace is not None, "endpoint.request",
                     parent=trace, job=payload.get("job")) as sp:
            resp = self.submit(**payload).result(timeout)
            wire = self.to_wire(resp)
            # which shared-state backend served this answer ("memory" /
            # "file" / "daemon", None for a process-local service), and
            # for a daemon, over which transport ("unix" | "tcp")
            wire["backend"] = self.service.backend_kind
            wire["backend_transport"] = self.service.backend_transport
            shards = self.service.backend_shards
            if shards is not None:
                # only present over a sharded backend: single-backend
                # wire answers keep their exact historical shape
                wire["backend_shards"] = [s["name"] for s in shards]
            wire["trace_id"] = sp.trace_id if sp is not None else None
            if include_trace:
                # opt-in ONLY: the rest of the wire answer stays stable
                lru_hits = max(0, resp.cache_hits - resp.store_hits)
                wire["trace"] = {
                    "stage_walls": dict(resp.stage_walls or {}),
                    "acquisition": {"fresh": resp.profiled,
                                    "lru_hits": lru_hits,
                                    "store_hits": resp.store_hits}}
        return wire

    def metrics(self) -> Dict:
        """Full telemetry snapshot (counters / gauges / histograms with
        p50/p95/p99) of the attached service — the wire form of
        `AllocationService.metrics()`, plus backend identity and the
        budget envelope when one is configured."""
        out = {"backend": self.service.backend_kind,
               "backend_transport": self.service.backend_transport,
               "backend_address": self.service.backend_address,
               "backend_shards": self.service.backend_shards,
               "metrics": self.service.metrics()}
        if self.service.budget is not None:
            out["budget"] = self.service.budget.snapshot()
        return out

    def stats(self) -> Dict:
        """Service counters + shared-state backend kind + profiling budget
        snapshot (including shared-envelope state), wire-friendly."""
        s = self.service.stats
        out = {"backend": self.service.backend_kind,
               "backend_transport": self.service.backend_transport,
               "backend_address": self.service.backend_address,
               "backend_shards": self.service.backend_shards,
               "requests": s.requests, "batches": s.batches,
               "profile_calls": s.profile_calls,
               "cache_hits": s.cache_hits, "store_hits": s.store_hits,
               "registry_hits": s.registry_hits,
               "plan_cache_hits": s.plan_cache_hits,
               "zoo_fits": s.zoo_fits, "zoo_confident": s.zoo_confident,
               "classifier_fallbacks": s.classifier_fallbacks,
               "baseline_fallbacks": s.baseline_fallbacks,
               "profile_hit_rate": s.profile_hit_rate,
               "adaptive_plans": s.adaptive_plans,
               "early_stops": s.early_stops,
               "escalations": s.escalations,
               "points_saved": s.points_saved,
               "budget_denied": s.budget_denied,
               "runtime_fits": s.runtime_fits,
               "runtime_confident": s.runtime_confident,
               "cost_objective_requests": s.cost_objective_requests,
               "objective_fallbacks": s.objective_fallbacks}
        if self.service.budget is not None:
            out["budget"] = self.service.budget.snapshot()
        return out

    @staticmethod
    def to_wire(resp: AllocationResponse) -> Dict:
        sel = resp.selection
        return {"job": resp.job, "signature": resp.signature,
                "source": resp.source, "candidate": resp.candidate,
                "neighbor": resp.neighbor,
                "requirement_gib": resp.requirement_gib,
                "config": sel.config.name,
                "usd_per_hour": sel.config.usd_per_hour,
                "method": sel.method, "fell_back": sel.fell_back,
                "profiled": resp.profiled, "cache_hits": resp.cache_hits,
                "wall_s": resp.wall_s, "early_stop": resp.early_stop,
                "escalated": resp.escalated,
                "budget_exhausted": resp.budget_exhausted,
                "placement": resp.placement,
                "objective": resp.objective,
                "objective_fell_back": sel.objective_fell_back,
                "predicted_runtime_s": sel.predicted_runtime_s,
                "predicted_cost_usd": sel.predicted_cost_usd,
                "runtime_candidate": resp.runtime_candidate}


# base rank of each cache leaf kind; batch axis = ndim - base_rank
_BATCH_RANK = {"k": 4, "v": 4, "ckv": 3, "kr": 3, "pos": 1,
               "h": 4, "conv": 3, "wkv": 4, "tm_last": 2, "cm_last": 2}


def _reset_slot(caches: Dict, slot: int) -> Dict:
    """Zero one slot's state across all (stacked, nested) cache leaves, IN
    PLACE: per-row `pos` goes to 0 so stale KV beyond it is never attended;
    recurrent states (wkv, h, conv, tm_last, cm_last) are cleared."""
    for name, leaf in caches.items():
        if isinstance(leaf, dict):
            _reset_slot(leaf, slot)
            continue
        rank = _BATCH_RANK.get(name)
        if rank is None or leaf.dim() < rank:
            continue
        leaf.select(leaf.dim() - rank, slot).zero_()
    return caches
