"""RWKV6 WKV recurrence: CUDA kernel, wrapper, plain version.

Replaces the Pallas kernel ``repro/kernels/wkv6.py`` (``wkv6``) together with
its wrapper ``repro/kernels/ops.py`` (``wkv6``), whose contract it keeps:
``(r, k, v, lw, u, state) -> (y float32, final state float32)``. The TPU
kernel starts from a zero state and returns y only; its wrapper adds the
incoming state's share of y and rebuilds the final state in a closed-form
pass over the whole sequence. Here both are folded into the kernel: it reads
the incoming state (or zeros) and writes the final state, chunk by chunk.

On an H100 the bfloat16 call at rwkv6-7b's prefill shape (B=4, S=2048,
H=64, K=64) is bound by bytes (0.47 GB, y and lw in float32, against 10.2
GFLOP of the chunked form); a decode step (S=1, one chunk of one row; 17 MB
of state read and written at B=8) by the launch. Both kernels
(``csrc/wkv6.cu``) keep the (K, K) state on the SM across chunks of 16 rows,
which is the TPU kernel's sequential grid dimension made a loop, and read r,
k, v and lw through their strides in ``(B, S, H, K)``, so the wrapper's
moveaxis and padded copies are gone; a chunk cut short by the end of the
sequence is masked in the kernel. The state may be updated in place
(``state_out=state``), as the decode path does with its cache.

- bfloat16 r, k, v: a block of K / 8 warps (four at least) owns a (batch,
  head). The chunk's A (the decayed r.k sums) is exact float32, one exp
  for each (t, j, channel); the two K x K products (r exp(cum_prev) times
  the state, and the update) run on the tensor cores with the float32
  operands split into high and low bfloat16 halves; the next chunk's tiles
  are copied by ``cp.async`` while this one computes; the state's float32
  master stays in registers. Splitting the value columns over two blocks
  (twice the grid, A computed twice) measured 2x slower at K = 64.
- float32 r, k, v: one block of 256 threads owns a (batch, head) and does
  every product as float32 FMAs from shared memory, which holds the float32
  gate of 1e-4 / 5e-4.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

HEAD_DIMS = (8, 16, 32, 64)


def wkv_chunked(r, k, v, lw, u, chunk: int, state=None):
    """Chunked WKV6 in plain PyTorch, the reference's ``wkv_chunked``.
    r, k, v: (B,S,H,K); lw: (B,S,H,K) log-decay (< 0); u: (H,K). Returns y
    (B,S,H,K) float32 and the final state (B,H,K,K) float32
    (state[k_dim, v_dim])."""
    B, S, H, K = r.shape
    f32 = torch.float32
    Q = min(chunk, S)
    pad = (-S) % Q
    r, k, v, lw = (a.to(f32) for a in (r, k, v, lw))
    if pad:
        # padded decay 0 => w = 1: the padded steps change nothing
        r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, lw))
    nC = (S + pad) // Q
    rc, kc, vc, wc = (a.reshape(B, nC, Q, H, K) for a in (r, k, v, lw))
    s_in = torch.zeros((B, H, K, K), dtype=f32, device=r.device) \
        if state is None else state.to(f32)
    u = u.to(f32)
    idx = torch.arange(Q, device=r.device)
    tri = (idx[:, None] > idx[None, :]).to(f32)              # strict lower
    ys = torch.empty((B, nC, Q, H, K), dtype=f32, device=r.device)
    for c in range(nC):
        rq, kq, vq, wq = rc[:, c], kc[:, c], vc[:, c], wc[:, c]   # (B,Q,H,K)
        cum = torch.cumsum(wq, dim=1)
        cum_prev = cum - wq
        # A[t,j] = sum_K r_t k_j exp(cum_prev[t] - cum[j]), j < t
        expo = cum_prev[:, :, None] - cum[:, None, :]          # (B,t,j,H,K)
        a = torch.einsum("bthk,bjhk,btjhk->bhtj", rq, kq,
                         torch.exp(torch.clamp(expo, max=0.0))) * tri
        diag = torch.einsum("bthk,hk,bthk->bth", rq, u, kq)    # bonus term
        y = torch.einsum("bhtj,bjhk->bthk", a, vq) + diag[..., None] * vq
        y = y + torch.einsum("bthk,bhkv->bthv", rq * torch.exp(cum_prev), s_in)
        tail = torch.exp(cum[:, -1:] - cum)
        s_in = s_in * torch.exp(cum[:, -1])[..., None] + \
            torch.einsum("bjhk,bjhv->bhkv", kq * tail, vq)
        ys[:, c] = y
    return ys.reshape(B, nC * Q, H, K)[:, :S], s_in


def wkv6_plain(r, k, v, lw, u, *, state=None, chunk: int = 16):
    """Plain PyTorch version of the wrapper's contract: (y, final state)."""
    return wkv_chunked(r, k, v, lw, u, chunk, state=state)


def _check(r, k, v, lw, u, state, state_out):
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape or \
            lw.shape != r.shape:
        raise ValueError("wkv6: r, k, v, lw must all be (B, S, H, K)")
    B, S, H, K = r.shape
    if tuple(u.shape) != (H, K):
        raise ValueError(f"wkv6: u {tuple(u.shape)}, wanted {(H, K)}")
    for name, t in (("state", state), ("state_out", state_out)):
        if t is not None and tuple(t.shape) != (B, H, K, K):
            raise ValueError(f"wkv6: {name} {tuple(t.shape)}, wanted "
                             f"{(B, H, K, K)}")
    tensors = [t for t in (r, k, v, lw, u, state, state_out) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("wkv6: inputs on different devices")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError("wkv6: r, k, v differ in dtype")


def _kernel_checks(r, k, v, lw, u, state, state_out) -> int:
    """What the kernels take beyond the contract; returns the dtype code.
    Raises on a dtype, K, empty shape or layout the kernels do not take."""
    code = build.DTYPE_CODES.get(r.dtype)
    if code is None:
        raise TypeError(f"wkv6 kernel takes float32 and bfloat16 r, k, v, "
                        f"got {r.dtype}")
    f32 = torch.float32
    if lw.dtype != f32 or u.dtype != f32 or \
            any(t is not None and t.dtype != f32 for t in (state, state_out)):
        raise TypeError("wkv6 kernel takes float32 lw, u and state")
    K = r.shape[-1]
    if K not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes K in {HEAD_DIMS}, got {K}")
    if r.numel() == 0:
        raise ValueError("wkv6: empty input")
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        if t.stride(3) != 1:
            raise ValueError(f"wkv6: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    for name, t in (("u", u), ("state", state), ("state_out", state_out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"wkv6: {name} must be contiguous")
    return code


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lw: torch.Tensor,
         u: torch.Tensor, *, state: Optional[torch.Tensor] = None,
         chunk: int = 16, state_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B,S,H,K); lw (B,S,H,K) float32; u (H,K) float32; state
    (B,H,K,K) float32 or None (zeros). Returns (y (B,S,H,K) float32, final
    state (B,H,K,K) float32). With `state_out` the final state is written
    there (it may be `state` itself) and that tensor is returned.

    A CPU tensor goes to the plain version (chunked with `chunk`). A CUDA
    tensor goes to the kernel, whose chunk is 16 whatever `chunk` says (the
    closed form is exact for any chunk), or the call raises: there is no
    other path for it.
    With grad mode on, a CUDA input that requires a gradient raises: the
    kernel has no backward yet.
    """
    _check(r, k, v, lw, u, state, state_out)
    if r.device.type == "cpu":
        y, new = wkv6_plain(r, k, v, lw, u, state=state, chunk=chunk)
        if state_out is not None:
            state_out.copy_(new)
            new = state_out
        return y, new
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    build.refuse_gradients("wkv6", r, k, v, lw, u, state)

    code = _kernel_checks(r, k, v, lw, u, state, state_out)
    B, S, H, K = r.shape
    f32 = torch.float32
    if state_out is None:
        state_out = torch.empty((B, H, K, K), dtype=f32, device=r.device)
    y = torch.empty((B, S, H, K), dtype=f32, device=r.device)
    build.launch("wkv6", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lw.data_ptr(), u.data_ptr(),
                 state.data_ptr() if state is not None else None,
                 state_out.data_ptr(), y.data_ptr(), B, S, H, K,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *lw.stride()[:3], code)
    wkv6.launches += 1
    return y, state_out


# number of kernel launches made through the wrapper
wkv6.launches = 0
