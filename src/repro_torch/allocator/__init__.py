"""Allocation service: batched, cached, model-zoo-backed resource allocation.

Crispy (arXiv:2206.13852) is a one-shot pipeline: sample -> profile ->
fit one linear model (R² > 0.99 gate) -> select a cluster config, with all
profiling work discarded when the gate fails. This package turns that loop
into a servable, stateful subsystem:

  model_zoo.py   Candidate-model registry — the paper's linear fit stays
                 the first/default candidate, joined by log-linear,
                 power-law and piecewise-linear fits. Leave-one-out CV
                 picks the simplest candidate within 10% of the best
                 held-out score; a `ZooFit` is a drop-in for
                 `LinearMemoryModel` (`CrispyAllocator(fitter=
                 zoo_fitter())`). Richer-candidate lineage: Ruya
                 (arXiv:2211.04240).

  registry.py    Persistent (JSON-backed, thread-safe) store of confident
                 memory models keyed by job signature — repeat requests
                 skip profiling entirely. Keeps each model's training
                 ladder so the classifier survives restarts.

  classifier.py  Flora-style nearest-job classification
                 (arXiv:2502.21046): scale-invariant features of a
                 profiling ladder (memory shape, runtime shape, and
                 categorical input-format/operator tags), nearest-neighbor
                 under a distance gate. Rescues jobs whose own profile
                 fails every model gate by transferring the neighbor's
                 model or best-known config.

  service.py     `AllocationService` — the batched/concurrent front over
                 the unified `repro_torch.pipeline.AllocationPipeline` (the ONE
                 staged decision path, shared with the one-shot
                 `CrispyAllocator`): worker thread + futures, drain-window
                 batching, per-signature plan dedup, a cross-batch
                 ProfileResult LRU the pipeline's acquisition stage reads
                 through, and wire-facing stats. All ladder/fit/selection
                 logic lives in `repro_torch.pipeline`; `adaptive=True` plans
                 with information-optimal point placement by default
                 (`placement="infogain"`, "ladder" keeps the
                 smallest-first prefix), `budget=` enforces the paper's ten-minute
                 envelope service-wide (cached points are never charged),
                 `store=`/`backend=` share state across processes, and
                 `executor=` profiles ladders and signature groups
                 concurrently.

Serving surface: `repro_torch.serve.engine.AllocationEndpoint` adapts the
service to dict-in/dict-out request handling next to the token-serving
`ServeEngine`; `benchmarks/allocation_service_throughput.py` measures
requests/sec and cache hit-rate; `benchmarks/profiling_adaptive.py`
compares fixed-vs-adaptive profiling cost.

A copy of the JAX package's ``repro/allocator/``. The benchmarks named
above are the JAX package's.
"""
from repro_torch.allocator.classifier import (Classification, NearestJobClassifier,
                                        TAG_WEIGHT, feature_distance,
                                        profile_features, runtime_features,
                                        tag_distance)
from repro_torch.allocator.model_zoo import (DEFAULT_CANDIDATES, LOOCV_GATE,
                                       LogLinearModel, MODEL_KINDS,
                                       PiecewiseLinearModel, PowerLawModel,
                                       RUNTIME_CANDIDATES,
                                       RUNTIME_LOOCV_GATE, RUNTIME_R2_GATE,
                                       RuntimeFit, RuntimeLinearModel,
                                       RuntimeLogLinearModel,
                                       RuntimePiecewiseLinearModel,
                                       RuntimePowerLawModel, ZooFit,
                                       fit_runtime_zoo, fit_zoo,
                                       model_from_dict, model_to_dict,
                                       zoo_fitter)
from repro_torch.allocator.registry import ModelRecord, ModelRegistry
from repro_torch.allocator.service import (AllocationRequest, AllocationResponse,
                                     AllocationService, ServiceStats)

__all__ = [
    "AllocationRequest", "AllocationResponse", "AllocationService",
    "Classification", "DEFAULT_CANDIDATES", "LOOCV_GATE", "LogLinearModel",
    "MODEL_KINDS", "ModelRecord", "ModelRegistry", "NearestJobClassifier",
    "PiecewiseLinearModel", "PowerLawModel", "RUNTIME_CANDIDATES",
    "RUNTIME_LOOCV_GATE", "RUNTIME_R2_GATE", "RuntimeFit",
    "RuntimeLinearModel", "RuntimeLogLinearModel",
    "RuntimePiecewiseLinearModel", "RuntimePowerLawModel", "ServiceStats",
    "TAG_WEIGHT", "ZooFit", "feature_distance", "fit_runtime_zoo",
    "fit_zoo", "model_from_dict", "model_to_dict", "profile_features",
    "runtime_features", "tag_distance", "zoo_fitter",
]
