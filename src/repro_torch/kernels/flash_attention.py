"""Flash attention (causal or not, GQA): CUDA kernels, wrapper, plain version.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py``
(``flash_attention``). On an H100 the function is bound by operations: at the
serving shapes the two matrix products dwarf the bytes of q, k, v and the
output. The kernels (``csrc/flash_attention.cu``) keep the score matrix out of
device memory with an online softmax; the walk over the keys, a sequential
grid dimension in the kernel it replaces, is a loop inside each block, cut at
the diagonal under the causal mask; q, k and v are read through their strides
in the ``(B, S, H, D)`` layout, so no transposed or padded copy is made; a
query head reads its kv head directly, so k and v are never repeated.

Because operations are the bound, bfloat16 inputs go to a Hopper kernel:
K and V arrive by TMA into a ring of shared-memory stages fed by a producer
warp (tiles of 128 keys, 64 at D = 192 so that a ring of three stages
fits), and two consumer warpgroups run both products as ``wgmma`` with
float32 accumulation (the probabilities are rounded to bfloat16 before the
second product, as the plain ``full_attention`` rounds them). Float32 inputs
keep plain float32 FMAs, exact to rounding.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
# 112: zamba2-7b; 192: deepseek-v3's MLA (q and k 128 + 64, v padded to it)
HEAD_DIMS = (16, 32, 64, 112, 128, 192)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version. q: (B,Sq,H,D); k, v: (B,Skv,Hkv,D). Arithmetic
    in float32, output in q.dtype; the causal mask is qpos >= kpos."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~(qpos >= kpos), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _check_strides(name: str, t: torch.Tensor) -> None:
    per16 = 16 // t.element_size()
    # the stride of a dimension of size 1 is never used
    if (t.shape[3] > 1 and t.stride(3) != 1) or t.data_ptr() % 16 or \
            any(t.stride(i) % per16 for i in range(3) if t.shape[i] > 1):
        raise ValueError(
            f"flash_attention: {name} needs a contiguous last dimension, "
            f"16-byte aligned rows and base address; got strides "
            f"{t.stride()}")


def kernel_strides(t: torch.Tensor) -> tuple:
    """Batch, sequence and head strides of a ``(B, S, H, D)`` tensor as the
    kernels take them. A dimension of size 1 is never stepped along, so its
    stride may be anything, but the bfloat16 kernel's TMA maps want every
    stride a multiple of 16 bytes: such a stride becomes the span of the
    dimension inside it."""
    strides = list(t.stride()[:3])
    inner = t.shape[3]                  # the span of the contiguous last dim
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            strides[i] = inner
        inner = strides[i] * t.shape[i]
    return tuple(strides)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,D); k, v: (B,Skv,Hkv,D) -> (B,Sq,H,D) in q.dtype.

    A CPU tensor goes to the plain version. A CUDA tensor goes to the kernel,
    or the call raises: there is no other path for it.
    With grad mode on, a CUDA input that requires a gradient raises: the
    kernel has no backward yet.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q (B,Sq,H,D); k, v (B,Skv,Hkv,D)")
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not go together")
    if not (q.dtype == k.dtype == v.dtype) or \
            not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v differ in dtype or device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    build.refuse_gradients("flash_attention", q, k, v)

    code = build.DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"flash_attention kernel takes float32 and bfloat16, "
                        f"got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {D}")
    if min(B, Sq, Skv, H) == 0:
        raise ValueError("flash_attention: empty q, k or v")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strides(name, t)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    build.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, Sq, Skv, H, Hkv, D,
                 *kernel_strides(q), *kernel_strides(k), *kernel_strides(v),
                 int(bool(causal)), 1.0 / math.sqrt(D), code)
    flash_attention.launches += 1
    key = (B, Sq, Skv, H, Hkv, D, bool(causal))
    flash_attention.launches_by_shape[key] = \
        flash_attention.launches_by_shape.get(key, 0) + 1
    return out


# number of kernel launches made through the wrapper, in all and by
# (B, Sq, Skv, H, Hkv, D, causal)
flash_attention.launches = 0
flash_attention.launches_by_shape = {}
