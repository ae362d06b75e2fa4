"""RMSNorm with an optional residual add: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``). On an
H100 the function is bound by bytes: every element is read once and written
once, and the arithmetic is a handful of operations an element. The kernel
(``csrc/rmsnorm.cu``) therefore gives one block to each row, moves the row in
16-byte vectors where its length and addresses allow, holds it in shared
memory as float32 between the reduction and the scaling so that device memory
sees one read and one write, and makes no padded copy of the rows. At a
handful of rows (one decode step) the time is the launch itself.

Like the kernel it replaces it returns the normed tensor only, not the sum
``x + residual``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: statistics in float32, output in x.dtype."""
    x32 = x.float()
    if residual is not None:
        x32 = x32 + residual.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., d), scale: (d,). Returns rms_norm(x [+ residual]) * scale.

    A CPU tensor goes to the plain version. A CUDA tensor goes to the kernel,
    or the call raises: there is no other path for it.
    """
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match d={d}")
    if residual is not None and (residual.shape != x.shape or
                                 residual.dtype != x.dtype or
                                 residual.device != x.device):
        raise ValueError("residual must match x in shape, dtype and device")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, x on {x.device}")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")

    codes = build.DTYPE_CODES
    if str(x.dtype) not in codes or str(scale.dtype) not in codes:
        raise TypeError(f"rmsnorm kernel takes float32 and bfloat16, got "
                        f"x {x.dtype}, scale {scale.dtype}")
    if x.numel() == 0:
        return torch.empty_like(x)
    x = x.contiguous()
    scale = scale.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    out = torch.empty_like(x)
    per16 = 16 // x.element_size()
    ptrs = [x.data_ptr(), out.data_ptr()]
    if residual is not None:
        ptrs.append(residual.data_ptr())
    vector = d % per16 == 0 and all(p % 16 == 0 for p in ptrs)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.rt_rmsnorm(
            x.data_ptr(), residual.data_ptr() if residual is not None else None,
            scale.data_ptr(), out.data_ptr(), x.numel() // d, d, float(eps),
            codes[str(x.dtype)], codes[str(scale.dtype)], int(vector),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "rmsnorm")
    rmsnorm.launches += 1
    return out


# number of kernel launches made through the wrapper
rmsnorm.launches = 0
