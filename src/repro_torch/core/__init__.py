"""Crispy over the port: the depth ladder, the linear memory model and its
R^2 gate, the GPU and AWS-like catalogs, the selectors, the profilers, of
which ``CUDAMemoryProfiler`` measures a step's peak memory on the card, the
planner, the one-shot ``CrispyAllocator`` and the paper's simulated and
local dataflow jobs."""
from repro_torch.core.catalog import (ClusterConfig, NodeType,
                                      aws_like_catalog, gpu_catalog,
                                      medium_config)
from repro_torch.core.crispy import CrispyAllocator, CrispyReport, ModelFitter
from repro_torch.core.history import Execution, ExecutionHistory
from repro_torch.core.hbm_planner import (GPU_OVERHEAD_GIB, HBMPlanner,
                                          PlanReport, gpu_profile_fn)
from repro_torch.core.memory_model import (R2_GATE, LinearMemoryModel,
                                           fit_memory_model)
from repro_torch.core.profiler import (CUDAMemoryProfiler, ProfileResult,
                                       RSSProfiler)
from repro_torch.core.sampling import integer_ladder, ladder_from_anchor
from repro_torch.core.selector import (Selection, random_expected_cost,
                                       select_bfa, select_crispy, select_like,
                                       select_medium)
