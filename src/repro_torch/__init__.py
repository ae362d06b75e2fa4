"""PyTorch and CUDA port of the `repro` package, for one NVIDIA H100.

Ported so far: the dense decoder-only family, RWKV6 (rwkv6-7b) and the
Zamba2 hybrid (zamba2-7b) through ``Model.forward``, ``Model.prefill``,
``Model.decode_step``, ``ServeEngine`` and the ``launch.serve`` command line,
with hand-written CUDA kernels for RMSNorm, flash attention, the RWKV6
recurrence (wkv6) and the Mamba2 scan (ssd). ``core/`` holds Crispy's
planner over the port: it profiles a step's peak memory on the card over a
depth ladder, extrapolates, and selects a GPU count. Entry points run on
the GPU and raise when there is none; pass ``device="cpu"`` to run the
plain PyTorch versions on the CPU.
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
