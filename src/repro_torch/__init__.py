"""PyTorch and CUDA port of the `repro` package, for NVIDIA H100s.

The six families of the JAX package (dense, MoE with GQA or MLA, RWKV6,
the Zamba2 hybrid, the VLM and the encoder-decoder) serve and train
through ``Model``, ``ServeEngine``, ``make_train_step`` and the
``launch.serve`` / ``launch.train`` command lines, with hand-written CUDA
kernels for RMSNorm and its backward, flash attention, the RWKV6
recurrence (wkv6) and the Mamba2 scan (ssd). ``core/`` holds Crispy's
planner over the port: it profiles a step's peak memory on the card over
a depth ladder (one rank of a sharded job, on a profile mesh),
extrapolates, and selects a GPU count; ``allocator/``, ``pipeline/``,
``profiling/``, ``state/`` and ``telemetry/`` its allocation service.
``sharding/`` and ``launch/mesh.py`` hold the multi-device machinery: the
sharding rules, the collectives over ``torch.distributed`` (or a rank run
alone), tensor, data and expert parallelism with ZeRO-1, and the GPipe
pipeline. Entry points run on the GPU and raise when there is none; pass
``device="cpu"`` to run the plain PyTorch versions on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the GPU, and is an error where there is none: nothing
    here carries on on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this package runs on the GPU by default; "
                "pass device='cpu' to run its plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype
