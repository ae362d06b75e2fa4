"""Mamba2 SSD chunked scan: CUDA kernels, wrapper, plain version.

Replaces the Pallas kernel ``repro/kernels/ssd.py`` (``ssd``) and keeps the
contract of its wrapper ``repro/kernels/ops.py`` (``ssd``):
``(xs, dt, A, Bm, Cm) -> (y float32, None)``; no final state is returned,
as the TPU kernel emits none.

On an H100 the bfloat16 call at zamba2-7b's prefill shape (B=4, S=2048,
H=112, P=N=64) is bound by bytes: 0.36 GB, two thirds of it the float32 y,
against 23 GFLOP of the chunked form. Both kernels (``csrc/ssd.cu``) keep the
(N, P) state on the SM across the sequence, which is the TPU kernel's
sequential grid dimension made a loop, and take a tile of **64 rows**, not
the reference's chunk of 256: the 256 x 256 float32 decay-weighted C B^T
tile alone would be 256 KB against 227 KB of shared memory a block, and y
does not depend on the tile but through rounding (the closed form is exact),
while the O(Q^2) work falls with it. ``chunk`` steers the plain version
only.

- bfloat16 xs, Bm, Cm: a block of four warps owns a (batch, head) and
  ``p_block(P)`` columns of P (the columns are independent, so 64 splits
  into two blocks of 32 and the grid doubles). The four products of a tile
  run on the tensor cores (``mma.sync`` bf16, float32 sums); the float32
  operands (M, the state, B scaled by the decay weights) go through a high
  and a low bfloat16 half, so they keep about 16 bits. The next tile's x, B,
  C and dt are copied by ``cp.async`` while this one computes.
- float32 xs, Bm, Cm: one block of 256 threads owns a (batch, head) and does
  the products as float32 FMAs from shared memory, which meets float32's
  2e-5 where TF32 products would not.

xs, Bm and Cm are read through their strides in ``(B, S, H, .)``, and Bm and
Cm may be ``expand()``ed views with a zero head stride, so ``mamba2`` hands
the kernel its one group as is instead of a repeated copy for every head. A
tile cut short by the end of the sequence is masked in the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

TILE = 64          # rows of the kernels' tile (csrc/ssd.cu, kSsdQ)
MAX_DIM = 64       # P and N the kernels take at most


def p_block(P: int) -> int:
    """Columns of P a block of the bfloat16 kernel takes: 16 up to P = 16,
    else 32 (ceil(P / 32) blocks a head). The kernel's register tiles come
    in these two widths."""
    return 16 if P <= 16 else 32


def ssd_chunked(xs, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD in plain PyTorch, the reference's ``ssd_chunked``.
    xs: (B,S,H,P); dt: (B,S,H) float32; A: (H,); Bm/Cm: (B,S,H,N). Returns
    y (B,S,H,P) float32 and the final state (B,H,N,P) float32."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    Q = min(chunk, S)
    pad = (-S) % Q
    xs, Bm, Cm, dt = (a.to(f32) for a in (xs, Bm, Cm, dt))
    A = A.to(f32)
    if pad:
        xs, Bm, Cm = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (xs, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nC = (S + pad) // Q
    xs_c = xs.reshape(B, nC, Q, H, P)
    dt_c = dt.reshape(B, nC, Q, H)
    Bm_c = Bm.reshape(B, nC, Q, H, N)
    Cm_c = Cm.reshape(B, nC, Q, H, N)
    h = torch.zeros((B, H, N, P), dtype=f32, device=xs.device) \
        if h0 is None else h0.to(f32)
    idx = torch.arange(Q, device=xs.device)
    causal = idx[:, None] >= idx[None, :]
    ys = torch.empty((B, nC, Q, H, P), dtype=f32, device=xs.device)
    for c in range(nC):
        xq, dq, bq, cq = xs_c[:, c], dt_c[:, c], Bm_c[:, c], Cm_c[:, c]
        cum = torch.cumsum(dq * A, dim=1)                      # (B,Q,H)
        # intra-chunk: M[b,h,i,j] = (C_i.B_j) exp(cum_i-cum_j) dt_j  (j<=i).
        # The mask goes in before the exp: for j > i the exponent is
        # positive and may overflow, and exp(inf) under a mask that zeroes
        # it after would make the backward 0 * inf = NaN
        cb = torch.einsum("bihn,bjhn->bhij", cq, bq)
        expo = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        dec = torch.exp(expo.masked_fill(~causal, float("-inf")))  # (B,H,i,j)
        m = cb * dec * dq.permute(0, 2, 1)[:, :, None, :]
        y = torch.einsum("bhij,bjhp->bihp", m, xq)
        y = y + torch.einsum("bihn,bhnp->bihp", cq, h) * \
            torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum)                  # (B,Q,H)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", bq * (tail * dq)[..., None], xq)
        ys[:, c] = y
    return ys.reshape(B, nC * Q, H, P)[:, :S], h


def ssd_plain(xs, dt, A, Bm, Cm, *, chunk: int = 128):
    """Plain PyTorch version of the wrapper's contract: (y, None)."""
    return ssd_chunked(xs, dt, A, Bm, Cm, chunk)[0], None


def ssd(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """xs (B,S,H,P); dt (B,S,H) float32; A (H,) float32; Bm, Cm (B,S,H,N)
    of xs's dtype, views with a zero head stride allowed. Returns
    (y (B,S,H,P) float32, None).

    A CPU tensor goes to the plain version (chunked with `chunk`). A CUDA
    tensor goes to the kernel (tile of 64 rows whatever `chunk` says), or
    the call raises: there is no other path for it.
    With grad mode on, a CUDA input that requires a gradient raises: the
    kernel has no backward yet.
    """
    if xs.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError("ssd: xs (B,S,H,P); Bm, Cm (B,S,H,N)")
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    if tuple(Bm.shape[:3]) != (B, S, H) or tuple(dt.shape) != (B, S, H) or \
            tuple(A.shape) != (H,):
        raise ValueError(f"ssd: xs {tuple(xs.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)} do not "
                         f"go together")
    if len({t.device for t in (xs, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd: inputs on different devices")
    if not (xs.dtype == Bm.dtype == Cm.dtype):
        raise ValueError("ssd: xs, Bm, Cm differ in dtype")
    if xs.device.type == "cpu":
        return ssd_plain(xs, dt, A, Bm, Cm, chunk=chunk)
    if xs.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {xs.device}")
    build.refuse_gradients("ssd", xs, dt, A, Bm, Cm)

    code = build.DTYPE_CODES.get(xs.dtype)
    if code is None:
        raise TypeError(f"ssd kernel takes float32 and bfloat16 xs, Bm, Cm, "
                        f"got {xs.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd kernel takes float32 dt and A")
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"ssd kernel takes P, N <= {MAX_DIM}, got P={P}, "
                         f"N={N}")
    if min(B, S, H, P, N) == 0:
        raise ValueError("ssd: empty input")
    for name, t in (("xs", xs), ("Bm", Bm), ("Cm", Cm)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"ssd: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    A = A.contiguous()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=xs.device)
    build.launch("ssd", xs.device, xs.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), B, S, H, P, N,
                 *xs.stride()[:3], *dt.stride(), *Bm.stride()[:3],
                 *Cm.stride()[:3], code, p_block(P))
    ssd.launches += 1
    return y, None


# number of kernel launches made through the wrapper
ssd.launches = 0
