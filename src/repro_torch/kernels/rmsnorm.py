"""RMSNorm with an optional residual add: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm``). On an
H100 the function is bound by bytes: every element is read once and written
once, and the arithmetic is a handful of operations an element. The kernel
(``csrc/rmsnorm.cu``) keeps a row in registers, spread over a power of two
of threads that each hold a few 16-byte vectors (``launch_shape`` picks them
so that no lane idles: 3584 bf16 = 64 threads x 7 vectors, 4096 = 64 x 8,
7168 = 128 x 7, 12288 = 256 x 6), reduces with warp shuffles and gives a
block of 256 threads several rows. A row that does not split so, or is not
16-byte aligned, takes the older kernel: one block a row, the row in shared
memory as float32. Neither makes a padded copy of the rows.

At a handful of rows (one decode step) the time is the call on the host, so
the wrapper does the least it can per call: dtype codes and the launch
shape from a cache keyed by ``torch.dtype``, a copy only of a tensor that is
not contiguous, alignment tested on the pointers' bits, the arguments packed
into one struct for ctypes, and the device switched only when it is not the
current one (``build.launch_packed``).

Like the kernel it replaces it returns the normed tensor only, not the sum
``x + residual``.

Gradients: on a CUDA tensor that requires a gradient (with grad mode on) the
wrapper goes through ``_RmsNormFn``, whose backward is the kernel
``rt_rmsnorm_backward`` of the same source (``rmsnorm_backward``, with
``rmsnorm_backward_plain`` beside it); the reference has no backward kernel
of its own, since its models never call their rmsnorm kernel. Under
``torch.no_grad()``, or when nothing requires a gradient, the call takes the
lean path above and pays nothing for autograd. A CPU tensor takes
``rmsnorm_plain``, which autograd differentiates.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_VECTORS = 8        # 16-byte vectors a thread holds (csrc/rmsnorm.cu, kMaxVec)
BLOCK_THREADS = 256    # threads of a block (kRegThreads) ...
ROW_THREADS = 512      # ... unless a float32 row takes more (kRegRowThreads)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: statistics in float32, output in x.dtype."""
    x32 = x.float()
    if residual is not None:
        x32 = x32 + residual.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def launch_shape(d: int, itemsize: int) -> Optional[Tuple[int, int, int]]:
    """(threads per row, 16-byte vectors per thread, rows per block) of the
    register kernel for rows of `d` elements of `itemsize` bytes: the fewest
    threads, a power of two, that hold the row's vectors with at most
    MAX_VECTORS each and every thread as many; up to BLOCK_THREADS, or
    ROW_THREADS for float32 (a bfloat16 row's vectors take twice the
    registers, which a block of 512 threads does not have). None when there
    are none: such a row takes the shared-memory kernel."""
    per16 = 16 // itemsize
    if d % per16:
        return None
    vectors = d // per16
    threads = 1
    while threads <= (ROW_THREADS if itemsize == 4 else BLOCK_THREADS):
        if vectors % threads == 0 and vectors // threads <= MAX_VECTORS:
            return threads, vectors // threads, max(1, BLOCK_THREADS // threads)
        threads *= 2
    return None


# the C entry's arguments (csrc/rmsnorm.cu, RmsnormArgs): x, residual, scale,
# out, rows, d, eps, dtypes, mode
_ARGS = struct.Struct("=QQQQqifii")

# per (d, x dtype, scale dtype): (dtype codes of the C entry, threads per
# row of the register kernel or 0, whether a row is whole 16-byte vectors)
_PLANS: Dict[tuple, Tuple[int, int, bool]] = {}


def _plan(d: int, x_dtype: torch.dtype,
          scale_dtype: torch.dtype) -> Tuple[int, int, bool]:
    x_code = build.DTYPE_CODES.get(x_dtype)
    scale_code = build.DTYPE_CODES.get(scale_dtype)
    if x_code is None or scale_code is None:
        raise TypeError(f"rmsnorm takes float32 and bfloat16, got "
                        f"x {x_dtype}, scale {scale_dtype}")
    itemsize = x_dtype.itemsize
    shape = launch_shape(d, itemsize)
    plan = (x_code | scale_code << 1, shape[0] if shape else 0,
            d * itemsize % 16 == 0)
    _PLANS[(d, x_dtype, scale_dtype)] = plan
    return plan


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., d), scale: (d,). Returns rms_norm(x [+ residual]) * scale.

    A CPU tensor goes to the plain version. A CUDA tensor goes to the kernel,
    or the call raises: there is no other path for it.
    """
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match d={d}")
    device = x.device
    if residual is not None and (residual.shape != x.shape or
                                 residual.dtype != x.dtype or
                                 residual.device != device):
        raise ValueError("residual must match x in shape, dtype and device")
    if scale.device != device:
        raise ValueError(f"scale on {scale.device}, x on {device}")
    codes, tpr, whole = _PLANS.get((d, x.dtype, scale.dtype)) or \
        _plan(d, x.dtype, scale.dtype)
    if not x.is_cuda:
        if device.type == "cpu":
            return rmsnorm_plain(x, scale, eps=eps, residual=residual)
        raise ValueError(f"rmsnorm: unsupported device {device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or scale.requires_grad or
            (residual is not None and residual.requires_grad)):
        # the Function's forward runs with grad mode off: back here, lean
        return _RmsNormFn.apply(x, scale, residual, eps)

    rows = x.numel() // d if d else 0
    if rows == 0:
        return torch.empty_like(x)
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    res_ptr = 0
    if residual is not None:
        if not residual.is_contiguous():
            residual = residual.contiguous()
        res_ptr = residual.data_ptr()
    out = torch.empty_like(x)
    x_ptr, out_ptr, scale_ptr = x.data_ptr(), out.data_ptr(), scale.data_ptr()
    # the register kernel (tpr threads a row), else the shared-memory kernel
    # with 16-byte vectors (0) or scalars (-1)
    if (x_ptr | out_ptr | res_ptr) & 15:
        mode = -1
    elif tpr and not scale_ptr & 15:
        mode = tpr
    else:
        mode = 0 if whole else -1
    build.launch_packed("rmsnorm", device, _ARGS, x_ptr, res_ptr, scale_ptr,
                        out_ptr, rows, d, eps, codes, mode)
    rmsnorm.launches += 1
    rmsnorm.launches_by_width[d] = rmsnorm.launches_by_width.get(d, 0) + 1
    return out


# number of kernel launches made through the wrapper, in all and by row width
rmsnorm.launches = 0
rmsnorm.launches_by_width = {}


def rmsnorm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                           g: torch.Tensor, *, eps: float = 1e-5,
                           residual: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, in float32: for h = x [+
    residual], rstd = rsqrt(mean(h^2) + eps), x_hat = h * rstd and the
    output's gradient g, returns (dx in x.dtype, dscale in scale.dtype) with

      dx     = rstd * (g * scale - x_hat * mean(g * scale * x_hat))
      dscale = sum over rows of g * x_hat.

    The residual's gradient is dx as well."""
    d = x.shape[-1]
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    rstd = torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + eps)
    x_hat = h * rstd
    g32 = g.float()
    gs = g32 * scale.float()
    dx = rstd * (gs - x_hat * (gs * x_hat).mean(dim=-1, keepdim=True))
    dscale = (g32 * x_hat).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


_SMS: Dict[int, int] = {}      # streaming multiprocessors of each card


def backward_grid(device: torch.device, rows: int, d: int) -> int:
    """Blocks of the backward's row kernel: about as many as the card holds
    at once (its shared memory is about 3 floats a column, and each SM has
    228 KB of which a block's own 1 KB is reserved), at most 8 an SM and at
    most one a row. The grid fixes the order in which dscale is summed, so
    it depends on the card and the shape only, never on the data."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    per_block = 12 * ((d + 3) // 4 * 4) + 512 + 1024
    per_sm = max(1, min(8, 228 * 1024 // per_block))
    return max(1, min(rows, sms * per_sm))


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     *, eps: float = 1e-5,
                     residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `rmsnorm`: (dx, dscale) for the output's gradient g,
    as `rmsnorm_backward_plain` computes them (the residual's gradient is
    dx). A CPU tensor goes to the plain version. A CUDA tensor goes to the
    kernel, or the call raises: there is no other path for it. dscale is
    the same to the bit on every call with the same inputs on one card."""
    d = x.shape[-1]
    if scale.shape != (d,) or g.shape != x.shape:
        raise ValueError(f"rmsnorm_backward: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, g {tuple(g.shape)} do not "
                         f"go together")
    device = x.device
    if residual is not None and (residual.shape != x.shape or
                                 residual.dtype != x.dtype or
                                 residual.device != device):
        raise ValueError("residual must match x in shape, dtype and device")
    if scale.device != device or g.device != device:
        raise ValueError(f"rmsnorm_backward: scale on {scale.device}, g on "
                         f"{g.device}, x on {device}")
    if device.type == "cpu":
        return rmsnorm_backward_plain(x, scale, g.to(x.dtype), eps=eps,
                                      residual=residual)
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_backward: unsupported device {device}")
    codes, _, whole = _PLANS.get((d, x.dtype, scale.dtype)) or \
        _plan(d, x.dtype, scale.dtype)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return torch.empty_like(x), torch.zeros_like(scale)
    x, scale = x.contiguous(), scale.contiguous()
    g = g.to(x.dtype).contiguous()
    res_ptr = 0
    if residual is not None:
        residual = residual.contiguous()
        res_ptr = residual.data_ptr()
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    blocks = backward_grid(device, rows, d)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=device)
    vector = whole and not (x.data_ptr() | g.data_ptr() | dx.data_ptr() |
                            res_ptr | scale.data_ptr()) & 15
    build.launch("rmsnorm_backward", device, x.data_ptr(), res_ptr,
                 scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 partial.data_ptr(), dscale.data_ptr(), rows, d, eps, codes,
                 blocks, int(vector))
    rmsnorm_backward.launches += 1
    rmsnorm_backward.launches_by_width[d] = \
        rmsnorm_backward.launches_by_width.get(d, 0) + 1
    return dx, dscale


# number of kernel launches made through the backward's wrapper, in all and
# by row width
rmsnorm_backward.launches = 0
rmsnorm_backward.launches_by_width = {}


class _RmsNormFn(torch.autograd.Function):
    """`rmsnorm` on CUDA tensors under autograd: the forward kernel, and the
    backward kernel for its gradient. x, scale and the residual are saved;
    the statistics are recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, scale, residual, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, residual)
        return rmsnorm(x, scale, eps=eps, residual=residual)

    @staticmethod
    def backward(ctx, g):
        x, scale, residual = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, g, eps=ctx.eps,
                                      residual=residual)
        return dx, dscale, (dx if residual is not None else None), None

