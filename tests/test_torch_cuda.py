"""Tests that need the card: the CUDA kernels against their plain versions,
and the model's kernel path against its plain path. Skipped where there is
no GPU; on the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, MLAConfig, RunConfig, get_arch
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (launch_shape, rmsnorm,
                                         rmsnorm_backward,
                                         rmsnorm_backward_plain, rmsnorm_plain)
from repro_torch.kernels.ssd import TILE, ssd, ssd_plain
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.models import Model
from repro_torch.models import moe as M
from repro_torch.models.attention import quantize_caches
from repro_torch.models.rwkv import wkv_recurrent
from repro_torch.models.ssm import ssd_recurrent
from repro_torch.train.step import loss_and_grads

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# wkv6 in float32: the chunked recurrence re-associated (tests/test_kernels.py)
WKV_TOL = {torch.float32: (1e-4, 5e-4), torch.bfloat16: (2e-2, 2e-2)}
# every width a norm of the port's configurations sees: d_model, the
# Mamba2 block's inner width (ssm_norm) of the hybrid family, and MLA's two
# latent ranks (q_norm, kv_norm)
NORM_WIDTHS = sorted({c.d_model for c in ARCHS.values()} |
                     {c.ssm.expand * c.d_model for c in ARCHS.values()
                      if c.family == "hybrid"} |
                     {r for c in ARCHS.values() if c.mla is not None
                      for r in (c.mla.q_lora_rank, c.mla.kv_lora_rank)})


@pytest.fixture
def card():
    # decided here, when the test runs, never while the module is imported
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    return torch.device("cuda")


def randn(card, seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(a).to(device=card, dtype=dtype)


def assert_close(got, want, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def laid_out(t, layout):
    """t (B, S, H, D) as the kernel may be handed it: contiguous; stored
    (B, H, S, D) and viewed as (B, S, H, D); or, for B = 1, with a batch
    stride of 7 elements, which TMA would refuse were it passed on."""
    if layout == "bhsd":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    if layout == "odd_batch_stride":
        B, S, H, D = t.shape
        assert B == 1
        view = torch.empty(S * H * D, dtype=t.dtype, device=t.device) \
            .as_strided((1, S, H, D), (7, H * D, D, 1))
        view.copy_(t)
        return view
    return t


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,layout", [
    (1, 32, 32, 2, 2, 16, "contiguous"), (2, 64, 64, 4, 2, 32, "contiguous"),
    (1, 96, 48, 4, 1, 64, "contiguous"), (2, 33, 65, 2, 2, 16, "contiguous"),
    (1, 200, 130, 8, 2, 128, "contiguous"),
    (2, 150, 150, 4, 2, 112, "contiguous"),
    # ragged tiles on both sides of the 128-row tiles, Sq < Skv and Sq > Skv
    (1, 127, 129, 4, 1, 128, "contiguous"), (2, 129, 127, 4, 2, 64, "contiguous"),
    (1, 255, 2049, 8, 8, 112, "contiguous"),
    (1, 2049, 255, 4, 2, 128, "contiguous"),
    (2, 1, 2049, 8, 2, 128, "contiguous"), (1, 2049, 1, 2, 1, 64, "contiguous"),
    (1, 129, 255, 32, 32, 64, "contiguous"),
    (2, 255, 129, 8, 2, 112, "bhsd"), (1, 129, 127, 4, 1, 128, "bhsd"),
    (1, 127, 255, 8, 2, 128, "odd_batch_stride"),
    (1, 1, 129, 4, 4, 112, "odd_batch_stride"),
    # D = 192 (MLA), key tiles of 64: ragged on both sides of them
    (1, 200, 130, 8, 8, 192, "contiguous"), (2, 63, 65, 4, 4, 192, "contiguous"),
    (1, 255, 2049, 8, 8, 192, "contiguous"),
    (1, 2049, 255, 4, 2, 192, "contiguous"),
    (2, 1, 2049, 4, 4, 192, "contiguous"), (1, 129, 127, 4, 1, 192, "bhsd"),
    (1, 127, 255, 8, 2, 192, "odd_batch_stride")])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(card, B, Sq, Sk, H, Hkv, D, layout, causal,
                                dtype):
    q = laid_out(randn(card, 0, (B, Sq, H, D), dtype), layout)
    k = laid_out(randn(card, 1, (B, Sk, Hkv, D), dtype), layout)
    v = laid_out(randn(card, 2, (B, Sk, Hkv, D), dtype), layout)
    key = (B, Sq, Sk, H, Hkv, D, causal)
    before = flash_attention.launches
    before_shape = flash_attention.launches_by_shape.get(key, 0)
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_shape[key] == before_shape + 1
    assert got.is_contiguous() and got.shape == (B, Sq, H, D)
    assert_close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


def test_flash_attention_kernel_reads_strided_views(card):
    """q, k, v as slices of one fused projection: strides, no copy."""
    B, S, H, D = 2, 70, 4, 64
    qkv = randn(card, 3, (B, S, 3, H, D), torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    assert_close(flash_attention(q, k, v, causal=True),
                 flash_attention_plain(q, k, v, causal=True), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_mla_head_dim(card, dtype):
    """The inputs MLA hands the kernel: q and k of 128 + 64 columns, k's
    last 64 one rotated key broadcast over the heads, v zero-padded from
    128 to 192; the padded third of the output is zero."""
    B, S, H = 2, 300, 16
    q = randn(card, 5, (B, S, H, 192), dtype)
    kr = randn(card, 6, (B, S, 1, 64), dtype)
    k = torch.cat([randn(card, 7, (B, S, H, 128), dtype),
                   kr.expand(B, S, H, 64)], dim=-1)
    v = torch.nn.functional.pad(randn(card, 8, (B, S, H, 128), dtype),
                                (0, 64))
    got = flash_attention(q, k, v, causal=True)
    assert_close(got, flash_attention_plain(q, k, v, causal=True), dtype)
    assert float(got[..., 128:].abs().max()) == 0.0


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 1, 1601, 8, 1, 128), (1, 64, 1601, 8, 1, 128),
    (2, 130, 1500, 3, 3, 64), (2, 1, 1500, 3, 3, 64),
    (1, 300, 300, 3, 3, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_cross_attention_shapes(card, B, Sq, Sk, H,
                                                          Hkv, D, dtype):
    """The VLM's and whisper's cross-attention, non-causal: key lengths of
    1601 and 1500 that end in a partial key tile, one decode query row. k
    and v are views of buffers whose rows past Sk hold NaN, which the
    output must not see."""
    q = randn(card, 12, (B, Sq, H, D), dtype)
    k, v = (randn(card, seed, (B, Sk + 64, Hkv, D), dtype).index_fill_(
        1, torch.arange(Sk, Sk + 64, device=card), float("nan"))[:, :Sk]
        for seed in (13, 14))
    got = flash_attention(q, k, v, causal=False)
    assert bool(torch.isfinite(got).all())
    assert_close(got, flash_attention_plain(q, k, v, causal=False), dtype)


def test_flash_attention_kernel_refuses_other_head_dims(card):
    q = randn(card, 4, (1, 8, 2, 48), torch.float32)
    with pytest.raises(ValueError, match="D in"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 96), (2, 5, 7, 128),
                                   (5, 70), (16, 4096), (2, 12288),
                                   (1, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel(card, shape, dtype, residual, scale_dtype):
    x = randn(card, 5, shape, dtype)
    r = randn(card, 6, shape, dtype) if residual else None
    sc = (1.0 + 0.1 * randn(card, 7, shape[-1:], torch.float32)).to(scale_dtype)
    before = rmsnorm.launches
    before_width = rmsnorm.launches_by_width.get(shape[-1], 0)
    got = rmsnorm(x, sc, residual=r)
    assert rmsnorm.launches == before + 1
    assert rmsnorm.launches_by_width[shape[-1]] == before_width + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert_close(got, rmsnorm_plain(x, sc, residual=r), dtype)


@pytest.mark.parametrize("d", NORM_WIDTHS)
@pytest.mark.parametrize("rows", [1, 8, 8192])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_kernel_at_model_widths(card, d, rows, residual):
    """bf16 rows of every norm width of the configurations, at a decode
    step's and a prefill's row counts: the register kernel's shapes."""
    assert launch_shape(d, 2) is not None
    dtype = torch.bfloat16
    x = randn(card, 8, (rows, d), dtype)
    r = randn(card, 9, (rows, d), dtype) if residual else None
    sc = (1.0 + 0.1 * randn(card, 10, (d,), torch.float32)).to(dtype)
    before = rmsnorm.launches
    got = rmsnorm(x, sc, residual=r)
    assert rmsnorm.launches == before + 1
    assert_close(got, rmsnorm_plain(x, sc, residual=r), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_strided_and_misaligned_views(card, dtype):
    """A non-contiguous x (copied, then the register kernel) and views one
    element off 16 bytes, x and residual (the shared-memory kernel's scalar
    path): the vector path's guard holds."""
    rows, d = 6, 4096
    sc = (1.0 + 0.1 * randn(card, 11, (d,), torch.float32)).to(dtype)
    wide = randn(card, 12, (rows, 2 * d), dtype)
    x = wide[:, ::2]
    assert not x.is_contiguous()
    assert_close(rmsnorm(x, sc), rmsnorm_plain(x, sc), dtype)
    flat = randn(card, 13, (2 * rows * d + 2,), dtype)
    xm = flat[1:rows * d + 1].view(rows, d)
    rm = flat[rows * d + 2:].view(rows, d)
    assert xm.data_ptr() % 16 and rm.data_ptr() % 16
    before = rmsnorm.launches
    got = rmsnorm(xm, sc, residual=rm)
    assert rmsnorm.launches == before + 1
    assert_close(got, rmsnorm_plain(xm, sc, residual=rm), dtype)
    odd_scale = randn(card, 14, (d + 1,), dtype)[1:]
    assert odd_scale.data_ptr() % 16
    assert_close(rmsnorm(x.contiguous(), odd_scale),
                 rmsnorm_plain(x, odd_scale), dtype)


def test_rmsnorm_kernel_runs_on_the_current_stream(card):
    """Inside ``torch.cuda.stream(s)`` the kernel runs on s: it sees a copy
    into x that s makes after a sleep, which a launch on the default stream
    would overtake."""
    rows, d = 8, 4096
    dtype = torch.bfloat16
    new = randn(card, 15, (rows, d), dtype)
    x = randn(card, 16, (rows, d), dtype)
    sc = (1.0 + 0.1 * randn(card, 17, (d,), torch.float32)).to(dtype)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert build.current_stream(card.index or 0) == s.cuda_stream
        torch.cuda._sleep(50_000_000)          # some tens of milliseconds
        x.copy_(new)
        got = rmsnorm(x, sc)
    assert build.current_stream(card.index or 0) != s.cuda_stream
    s.synchronize()
    assert_close(got, rmsnorm_plain(new, sc), dtype)


def assert_dscale_close(got, want, dtype):
    """dscale is a sum over the rows: held relative to its largest entry,
    1e-4 in float32 (the sums taken in another order), bf16's 2e-2."""
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    big = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=tol * big,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 96), (5, 70), (16, 4096),
                                   (8, 3584), (2, 12288), (64, 7168)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel(card, shape, dtype, residual, scale_dtype):
    x = randn(card, 30, shape, dtype)
    r = randn(card, 31, shape, dtype) if residual else None
    g = randn(card, 32, shape, dtype)
    sc = (1.0 + 0.1 * randn(card, 33, shape[-1:], torch.float32)).to(scale_dtype)
    before = rmsnorm_backward.launches
    dx, dscale = rmsnorm_backward(x, sc, g, residual=r)
    assert rmsnorm_backward.launches == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    assert dscale.dtype == scale_dtype and dscale.shape == sc.shape
    want_dx, want_dscale = rmsnorm_backward_plain(x, sc, g, residual=r)
    assert_close(dx, want_dx, dtype)
    assert_dscale_close(dscale, want_dscale, scale_dtype)


@pytest.mark.parametrize("rows,d", [(3000, 768), (2048, 8192)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_backward_kernel_in_float32_at_new_train_widths(card, rows, d,
                                                                residual):
    """The rows of whisper's encoder at B = 2 (d 768) and of the vlm's
    full-width train step (d 8192; a float32 row holds h and g in shared
    memory, 64 KB of it), in float32 as the train launcher runs them."""
    f32 = torch.float32
    x, g = randn(card, 45, (rows, d), f32), randn(card, 46, (rows, d), f32)
    r = randn(card, 47, (rows, d), f32) if residual else None
    sc = 1.0 + 0.1 * randn(card, 48, (d,), f32)
    before = rmsnorm_backward.launches
    dx, dscale = rmsnorm_backward(x, sc, g, residual=r)
    assert rmsnorm_backward.launches == before + 1
    want_dx, want_dscale = rmsnorm_backward_plain(x, sc, g, residual=r)
    assert_close(dx, want_dx, f32)
    assert_dscale_close(dscale, want_dscale, f32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_autograd_on_the_card_launches_both_kernels(card, dtype,
                                                             residual):
    """Under autograd a CUDA input goes through the forward kernel and the
    backward kernel, once each, and the gradients are autograd's of the
    plain version on the CPU."""
    shape = (2, 24, 4096)
    x = randn(card, 34, shape, dtype).requires_grad_()
    r = randn(card, 35, shape, dtype).requires_grad_() if residual else None
    sc = (1.0 + 0.1 * randn(card, 36, (4096,), torch.float32)).requires_grad_()
    g = randn(card, 37, shape, dtype)
    fwd, bwd = rmsnorm.launches, rmsnorm_backward.launches
    y = rmsnorm(x, sc, residual=r)
    assert y.grad_fn is not None
    y.backward(g)
    assert (rmsnorm.launches, rmsnorm_backward.launches) == (fwd + 1, bwd + 1)
    leaves = [t.detach().cpu().requires_grad_() for t in (x, sc)]
    r_cpu = r.detach().cpu().requires_grad_() if residual else None
    rmsnorm_plain(*leaves, residual=r_cpu).backward(g.cpu())
    assert_close(x.grad.cpu(), leaves[0].grad, dtype)
    assert_dscale_close(sc.grad.cpu(), leaves[1].grad, dtype)
    if residual:
        assert_close(r.grad.cpu(), r_cpu.grad, dtype)
    with torch.no_grad():                 # the lean path: no backward
        assert rmsnorm(x, sc).grad_fn is None


def test_rmsnorm_backward_dscale_is_the_same_to_the_bit(card):
    """No atomics: two calls on the same inputs give the same bits."""
    x = randn(card, 38, (8192, 4096), torch.float32)
    g = randn(card, 39, (8192, 4096), torch.float32)
    sc = 1.0 + 0.1 * randn(card, 40, (4096,), torch.float32)
    dx1, ds1 = rmsnorm_backward(x, sc, g)
    dx2, ds2 = rmsnorm_backward(x, sc, g)
    torch.cuda.synchronize()
    assert torch.equal(ds1, ds2) and torch.equal(dx1, dx2)


def test_wrappers_without_a_backward_refuse_inputs_that_need_one(card):
    """flash_attention, wkv6 and ssd raise on a CUDA input that requires a
    gradient instead of handing back an output autograd cannot see
    through; under no_grad they launch as before."""
    f32 = torch.float32
    q = randn(card, 41, (1, 32, 2, 64), f32).requires_grad_()
    with pytest.raises(RuntimeError, match="Queue 2"):
        flash_attention(q, q.detach(), q.detach())
    r = randn(card, 42, (1, 16, 2, 16), f32).requires_grad_()
    lw = -torch.exp(randn(card, 43, (1, 16, 2, 16), f32))
    u = randn(card, 44, (2, 16), f32)
    with pytest.raises(RuntimeError, match="Queue 2"):
        wkv6(r, r.detach(), r.detach(), lw, u)
    xs = randn(card, 45, (1, 16, 2, 8), f32).requires_grad_()
    dt = torch.rand((1, 16, 2), device=card)
    A = -torch.rand((2,), device=card)
    Bm = randn(card, 46, (1, 16, 2, 4), f32)
    with pytest.raises(RuntimeError, match="Queue 2"):
        ssd(xs, dt, A, Bm, Bm)
    with torch.no_grad():
        before = (flash_attention.launches, wkv6.launches, ssd.launches)
        flash_attention(q, q, q)
        wkv6(r, r, r, lw, u)
        ssd(xs, dt, A, Bm, Bm)
        torch.cuda.synchronize()
        assert (flash_attention.launches, wkv6.launches, ssd.launches) == \
            tuple(n + 1 for n in before)


# + the bf16 kernel's boundaries: one row (a decode step), 15, 16 and 17
# rows and 33 (a short last chunk, one whole chunk, one past it), every K
# (four warps up to K = 32, eight at 64; K = 8 padded to an mma step)
@pytest.mark.parametrize("B,S,H,K", [(1, 16, 1, 8), (2, 40, 3, 16),
                                     (1, 33, 2, 32), (2, 100, 4, 64),
                                     (2, 1, 3, 64), (1, 15, 2, 8),
                                     (2, 16, 2, 64), (1, 17, 3, 16),
                                     (2, 17, 2, 32), (1, 33, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_kernel(card, B, S, H, K, dtype, with_state):
    r, k, v = (randn(card, 10 + i, (B, S, H, K), dtype) for i in range(3))
    lw = -torch.exp(randn(card, 13, (B, S, H, K), torch.float32))
    u = 0.3 * randn(card, 14, (H, K), torch.float32)
    state = randn(card, 15, (B, H, K, K), torch.float32) if with_state else None
    before = wkv6.launches
    y, st = wkv6(r, k, v, lw, u, state=state)
    assert wkv6.launches == before + 1
    want_y, want_st = wkv6_plain(r, k, v, lw, u, state=state)
    atol, rtol = WKV_TOL[dtype]
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_decode_step_in_place(card, dtype):
    """S = 1 with the state read and written in place, as every decode step
    of rwkv6 does with its cache; then a strided (B, S, H, K) view."""
    B, H, K = 8, 4, 64
    r, k, v = (randn(card, 20 + i, (B, 1, H, K), dtype) for i in range(3))
    lw = -torch.exp(randn(card, 23, (B, 1, H, K), torch.float32))
    u = 0.3 * randn(card, 24, (H, K), torch.float32)
    state = randn(card, 25, (B, H, K, K), torch.float32)
    want_y, want_st = wkv6_plain(r, k, v, lw, u, state=state.clone())
    y, st = wkv6(r, k, v, lw, u, state=state, state_out=state)
    assert st is state
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=5e-4)
    torch.testing.assert_close(state, want_st, atol=1e-4, rtol=5e-4)
    rkv = randn(card, 26, (2, 30, 3, H, K), dtype)      # fused r, k, v
    lw = -torch.exp(randn(card, 27, (2, 30, H, K), torch.float32))
    parts = rkv[:, :, 0], rkv[:, :, 1], rkv[:, :, 2]
    assert not parts[0].is_contiguous()
    y, st = wkv6(*parts, lw, u)
    want_y, want_st = wkv6_plain(*parts, lw, u)
    atol, rtol = WKV_TOL[dtype]
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_decode_steps_replay_in_a_cuda_graph(card, dtype):
    """rwkv6-7b's decode step (B = 8 slots, H = 64, K = 64, the state in
    place) captured in a CUDA graph for 8 steps and replayed: the same y
    and state as the steps run one by one on the plain version. Prints the
    kernel's time a step on the device alone (the graph has no host cost)."""
    B, H, K, steps = 8, 64, 64, 8
    r, k, v = (randn(card, 100 + i, (steps, B, 1, H, K), dtype) for i in range(3))
    lw = -torch.exp(-0.6 + 0.5 * randn(card, 103, (steps, B, 1, H, K),
                                       torch.float32))
    u = 0.1 * randn(card, 104, (H, K), torch.float32)
    state0 = randn(card, 105, (B, H, K, K), torch.float32)
    state = state0.clone()
    ys = torch.empty((steps, B, 1, H, K), dtype=torch.float32, device=card)

    def run():
        for i in range(steps):
            y, _ = wkv6(r[i], k[i], v[i], lw[i], u, state=state, state_out=state)
            ys[i].copy_(y)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                                    # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    state.copy_(state0)
    graph.replay()
    want_st = state0.clone()
    for i in range(steps):
        want_y, want_st = wkv6_plain(r[i], k[i], v[i], lw[i], u, state=want_st)
        torch.testing.assert_close(ys[i], want_y, atol=WKV_TOL[dtype][0],
                                   rtol=WKV_TOL[dtype][1])
    torch.testing.assert_close(state, want_st, atol=1e-3, rtol=1e-3)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = None
    for _ in range(3):
        start.record()
        for _ in range(20):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        us = start.elapsed_time(end) / (20 * steps) * 1e3
        best = us if best is None else min(best, us)
    print(f"wkv6 {dtype} decode step (8, 1, 64, 64) in place, in a CUDA "
          f"graph: {best:.2f} us a step on the device (with the copy of y; "
          f"least of 3 rounds of 20 replays)")


def test_wkv6_kernel_reads_unaligned_rows(card):
    """r, k, v and lw one element off 16 bytes: element-wise loads in the
    bf16 kernel instead of cp.async."""
    B, S, H, K = 2, 40, 2, 64
    dtype = torch.bfloat16
    r, k, v = (randn(card, 80 + i, (B, S, H, K), dtype) for i in range(3))
    lw = -torch.exp(randn(card, 83, (B, S, H, K), torch.float32))
    u = 0.3 * randn(card, 84, (H, K), torch.float32)
    r_o, k_o, v_o, lw_o = (torch.cat([t[..., :1], t], dim=-1)[..., 1:]
                           for t in (r, k, v, lw))
    assert r_o.data_ptr() % 16 and torch.equal(lw_o, lw)
    y, st = wkv6(r_o, k_o, v_o, lw_o, u)
    want_y, want_st = wkv6_plain(r, k, v, lw, u)
    atol, rtol = WKV_TOL[dtype]
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want_y, atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


def test_wkv6_kernel_bf16_over_2048_rows(card):
    """bf16 over 2048 rows (128 chunks) with rwkv6-7b's decay (w0 = -0.6
    plus a small data-dependent term) and bonus: the state is carried
    through every chunk; within bf16's tolerance of the plain version, and
    the worst error against a float64 step recurrence printed."""
    B, S, H, K = 1, 2048, 4, 64
    dtype = torch.bfloat16
    r, k, v = (randn(card, 90 + i, (B, S, H, K), dtype) for i in range(3))
    lw = -torch.exp(-0.6 + 0.5 * randn(card, 93, (B, S, H, K), torch.float32))
    u = 0.1 * randn(card, 94, (H, K), torch.float32)
    y, st = wkv6(r, k, v, lw, u)
    want_y, want_st = wkv6_plain(r, k, v, lw, u)
    exact_y, exact_st = wkv_recurrent(r, k, v, lw, u, dtype=torch.float64)
    torch.cuda.synchronize()
    print(f"wkv6 bf16 over {S} rows: max abs err {float((y - want_y).abs().max()):.3e} "
          f"against wkv6_plain, {float((y.double() - exact_y).abs().max()):.3e} "
          f"against float64 (plain: {float((want_y.double() - exact_y).abs().max()):.3e}); "
          f"state {float((st.double() - exact_st).abs().max()):.3e}; max |y| "
          f"{float(exact_y.abs().max()):.3e}")
    atol, rtol = WKV_TOL[dtype]
    torch.testing.assert_close(y, want_y, atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


def ssd_inputs(card, B, S, H, P, N, dtype, seed=0):
    """The reference test's distributions up to one tile; past it, mamba2's
    (dt = softplus(proj + dt_bias) small, A from -1 to -16): with the
    reference's over hundreds of rows y becomes a sum of terms of a few
    hundred that cancel, and float32 rounding alone passes 2e-5."""
    xs = randn(card, seed, (B, S, H, P), dtype)
    if S > TILE:
        dt = torch.nn.functional.softplus(
            0.5 * randn(card, seed + 1, (B, S, H), torch.float32) - 4.0)
        A = -torch.linspace(1.0, 16.0, H, device=card)
    else:
        dt = torch.nn.functional.softplus(
            randn(card, seed + 1, (B, S, H), torch.float32))
        A = -torch.exp(randn(card, seed + 2, (H,), torch.float32))
    Bm = randn(card, seed + 3, (B, S, H, N), dtype)
    Cm = randn(card, seed + 4, (B, S, H, N), dtype)
    return xs, dt, A, Bm, Cm


# the bf16 tensor-core kernel's boundaries: sequences around the 64-row
# tile; P and N of 8 to 64, in pairs that cross its blocks along P (16, 32)
# and its padding of N to 16; P, N no multiple of 8 (element-wise loads)
SSD_BF16_SHAPES = [(2, 1, 3, 8, 16), (1, 63, 2, 32, 4), (2, 64, 2, 16, 32),
                   (1, 65, 3, 64, 8), (1, 200, 2, 8, 64), (2, 65, 2, 32, 32),
                   (1, 63, 2, 64, 16), (1, 129, 2, 40, 24), (1, 70, 2, 12, 20)]


@pytest.mark.parametrize("B,S,H,P,N", [(1, 32, 2, 16, 8), (2, 50, 3, 8, 16),
                                       (1, 16, 1, 32, 4), (2, 200, 4, 64, 64),
                                       (1, 1, 2, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel(card, B, S, H, P, N, dtype):
    xs, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, dtype)
    before = ssd.launches
    got, none = ssd(xs, dt, A, Bm, Cm, chunk=256)
    assert ssd.launches == before + 1 and none is None
    # against the plain version over the kernel's tile, so that both sum the
    # decay over the same rows: over 200 rows the running sum of dt * A
    # reaches a few hundred and its float32 rounding alone moves y by ~1e-4
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ssd_plain(xs, dt, A, Bm, Cm, chunk=TILE)[0],
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,P,N", SSD_BF16_SHAPES)
def test_ssd_bf16_kernel_at_tile_and_block_boundaries(card, B, S, H, P, N):
    """The bf16 kernel against the plain version at the kernel's tile.
    bf16 only: at one whole tile of the reference test's dt and A (S = 63,
    64) the float32 kernel's rounding passes float32's 2e-5 (up to 1.9e-4,
    ROADMAP Queue 3)."""
    dtype = torch.bfloat16
    xs, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, dtype)
    before = ssd.launches
    got, none = ssd(xs, dt, A, Bm, Cm)
    assert ssd.launches == before + 1 and none is None
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ssd_plain(xs, dt, A, Bm, Cm, chunk=TILE)[0],
                               atol=TOL[dtype], rtol=TOL[dtype])


# the float32 kernel against a float64 step recurrence, with the reference
# test's dt and A (tests/test_kernels.py) over at most one tile: the two
# shapes of the SSD_BF16_SHAPES where it once missed 2e-5 against
# ssd_plain, and the other two of at most one tile
@pytest.mark.parametrize("B,S,H,P,N", [(2, 64, 2, 16, 32), (1, 63, 2, 64, 16),
                                       (2, 1, 3, 8, 16), (1, 63, 2, 32, 4)])
def test_ssd_f32_kernel_against_float64_recurrence(card, B, S, H, P, N):
    xs, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, torch.float32)
    got, _ = ssd(xs, dt, A, Bm, Cm)
    plain, _ = ssd_plain(xs, dt, A, Bm, Cm, chunk=TILE)
    want, _ = ssd_recurrent(xs, dt, A, Bm, Cm, dtype=torch.float64)
    torch.cuda.synchronize()
    scale = 1.0 + want.abs()
    print(f"ssd f32 {(B, S, H, P, N)} against float64: kernel "
          f"{float((got.double() - want).abs().max()):.3e} "
          f"(/(1+|y|) {float(((got.double() - want).abs() / scale).max()):.3e}), "
          f"plain {float((plain.double() - want).abs().max()):.3e} "
          f"(/(1+|y|) {float(((plain.double() - want).abs() / scale).max()):.3e})")
    torch.testing.assert_close(got.double(), want, atol=TOL[torch.float32],
                               rtol=TOL[torch.float32])


@pytest.mark.parametrize("B,S,H,P,N", [(2, 130, 6, 64, 64), (1, 65, 3, 32, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_one_group_expanded(card, B, S, H, P, N, dtype):
    """Bm / Cm of one group as expand()ed views (zero head stride), as
    mamba2 hands them over, against the repeated tensors."""
    xs, dt, A, _, _ = ssd_inputs(card, B, S, H, P, N, dtype, seed=30)
    bg, cg = (randn(card, 40 + i, (B, S, 1, N), dtype) for i in range(2))
    Bx, Cx = bg.expand(B, S, H, N), cg.expand(B, S, H, N)
    assert Bx.stride(2) == 0
    got, _ = ssd(xs, dt, A, Bx, Cx)
    want, _ = ssd_plain(xs, dt, A, Bx.contiguous(), Cx.contiguous(), chunk=TILE)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_ssd_kernel_bf16_over_2048_rows(card):
    """bf16 over 2048 rows (32 tiles) with mamba2's dt and A and one group of
    B, C: the state grows to hundreds, and the hi/lo halves of the float32
    operands keep y within bf16's tolerance of the plain version at the
    kernel's tile."""
    B, S, H, P, N = 1, 2048, 4, 64, 64
    dtype = torch.bfloat16
    xs, dt, A, _, _ = ssd_inputs(card, B, S, H, P, N, dtype, seed=50)
    bg, cg = (randn(card, 60 + i, (B, S, 1, N), dtype) for i in range(2))
    Bx, Cx = bg.expand(B, S, H, N), cg.expand(B, S, H, N)
    got, _ = ssd(xs, dt, A, Bx, Cx)
    want, _ = ssd_plain(xs, dt, A, Bx, Cx, chunk=TILE)
    torch.cuda.synchronize()
    print(f"ssd bf16 over {S} rows: max abs err "
          f"{float((got - want).abs().max()):.3e}, max |y| "
          f"{float(want.abs().max()):.3e}")
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_reads_unaligned_rows(card, dtype):
    """xs, Bm and Cm one element off 16 bytes: element-wise loads in the bf16
    kernel instead of cp.async."""
    B, S, H, P, N = 1, 100, 2, 32, 16
    xs, dt, A, Bm, Cm = ssd_inputs(card, B, S, H, P, N, dtype, seed=70)
    xs_o, Bm_o, Cm_o = (torch.cat([t[..., :1], t], dim=-1)[..., 1:]
                        for t in (xs, Bm, Cm))
    assert xs_o.data_ptr() % 16 and torch.equal(xs_o, xs)
    got, _ = ssd(xs_o, dt, A, Bm_o, Cm_o)
    want, _ = ssd_plain(xs, dt, A, Bm, Cm, chunk=TILE)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_recurrent_models_kernel_path_matches_plain_path(card, arch):
    """Reduced rwkv6-7b / zamba2-7b, float32: the card's kernels against
    the plain path on the card and the model on the CPU, forward and
    decode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).reduced()
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    gpu = Model(cfg, run).init(seed=0)
    cpu = Model(cfg, run, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    full = Model(cfg, run.with_(attn_impl="full"))
    full.load_state_dict(gpu.state_dict())
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 40))
    got = gpu.forward({"tokens": toks})
    torch.testing.assert_close(got, full.forward({"tokens": toks}),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu.forward({"tokens": toks}),
                               atol=1e-4, rtol=1e-4)
    caches = gpu.init_caches(2, 48)
    steps = []
    for t in range(8):
        lg, caches = gpu.decode_step({"tokens": toks[:, t:t + 1]}, caches)
        steps.append(lg[:, 0])
    ref = gpu.forward({"tokens": toks[:, :8]})
    assert float((torch.stack(steps, 1) - ref).abs().max()) < 5e-4


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_vlm_and_encdec_kernel_path_matches_plain_path(card, arch):
    """Reduced llama-3.2-vision-90b (gates set to 0.5) / whisper-small,
    float32, random media or frames: the card's kernels (cross-attention
    included) against the plain attention on the card and the model on the
    CPU; decode, fed the media or the encoder's output, against forward."""
    from repro_torch.models.transformer import encdec_encode
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).reduced()
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    gpu = Model(cfg, run).init(seed=0)
    if cfg.family == "vlm":
        gpu.params["layers"]["cross"]["attn"]["gate"].fill_(0.5)
        extra = {"media": randn(card, 15, (2, cfg.cross_attn.n_media_tokens,
                                           cfg.d_model), torch.float32)}
    else:
        extra = {"frames": randn(card, 15, (2, cfg.encdec.enc_len,
                                            cfg.d_model), torch.float32)}
    cpu = Model(cfg, run, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    full = Model(cfg, run.with_(attn_impl="full"))
    full.load_state_dict(gpu.state_dict())
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(2, 40))
    batch = {"tokens": toks, **extra}
    got = gpu.forward(batch)
    torch.testing.assert_close(got, full.forward(batch), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        got.cpu(), cpu.forward({"tokens": toks,
                                **{k: v.cpu() for k, v in extra.items()}}),
        atol=1e-4, rtol=1e-4)
    if cfg.family == "audio":
        with torch.no_grad():
            extra = {"enc_out": encdec_encode(gpu.params["layers"],
                                              extra["frames"], cfg, run)}
    caches = gpu.init_caches(2, 48)
    before = flash_attention.launches
    kv = next(iter(extra.values())).shape[1]
    key = (2, 1, kv, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, False)
    before_shape = flash_attention.launches_by_shape.get(key, 0)
    steps = []
    for t in range(8):
        lg, caches = gpu.decode_step({"tokens": toks[:, t:t + 1], **extra},
                                     caches)
        steps.append(lg[:, 0])
    cross = cfg.n_layers // (cfg.cross_attn.period if cfg.cross_attn else 1)
    assert flash_attention.launches == before + 8 * cross
    # every launch of a step is the cross-attention's one query row
    assert flash_attention.launches_by_shape[key] == before_shape + 8 * cross
    assert float((torch.stack(steps, 1) - got[:, :8]).abs().max()) < 5e-4


def small_moe(arch):
    """A reduced MoE config whose attention reaches the kernel: for MLA the
    full model's head dims (128 + 64, v 128), so that its core runs at the
    kernel's D = 192 (the reduced config's 16 + 8 has no kernel instance)."""
    cfg = get_arch(arch).reduced()
    if cfg.attention_kind == "mla":
        cfg = get_arch(arch).reduced(mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=128, qk_rope_dim=64,
            v_head_dim=128))
    return cfg


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_models_kernel_path_matches_plain_path(card, arch):
    """Reduced olmoe-1b-7b / deepseek-v3-671b, float32: the card's kernels
    (flash attention at D = 16, or at D = 192 for MLA) against the plain
    attention on the card and the model on the CPU; prefill, then decode
    against forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = small_moe(arch)
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    gpu = Model(cfg, run).init(seed=0)
    cpu = Model(cfg, run, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    full = Model(cfg, run.with_(attn_impl="full"))
    full.load_state_dict(gpu.state_dict())
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, size=(2, 40))
    before = flash_attention.launches
    got = gpu.forward({"tokens": toks})
    assert flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(got, full.forward({"tokens": toks}),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu.forward({"tokens": toks}),
                               atol=1e-4, rtol=1e-4)
    lg, caches = gpu.prefill({"tokens": toks[:, :32]}, 48)
    torch.testing.assert_close(lg[:, 0], got[:, 31], atol=1e-5, rtol=1e-5)
    steps = []
    for t in range(32, 40):
        step, caches = gpu.decode_step({"tokens": toks[:, t:t + 1]}, caches)
        steps.append(step[:, 0])
    assert float((torch.stack(steps, 1) - got[:, 32:]).abs().max()) < 5e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_gives_the_same_bits_twice(card, dtype):
    """The dispatch and the combine (a gather into (T, k, d) and a sum over
    k) use no atomics: two runs agree to the bit. In float32 the result is
    the dropless plain version's within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("deepseek-v3-671b").reduced(n_experts=16)
    p = M.init_moe(torch.Generator(device=card).manual_seed(0), cfg,
                   dtype=dtype, device=card)
    x = randn(card, 11, (4, 256, cfg.d_model), dtype)
    a, aux_a = M.moe(p, x, cfg)
    b, aux_b = M.moe(p, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    if dtype == torch.float32:
        want, aux = M.moe_dense(p, x, cfg)
        torch.testing.assert_close(a, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(aux_a, aux, atol=1e-5, rtol=1e-5)


def test_model_kernel_path_matches_plain_path(card):
    """Reduced chatglm3-6b (GQA 4/2, partial rotation), float32: the card's
    kernels against the plain attention on the card and the model on the
    CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("chatglm3-6b").reduced()
    run = RunConfig(param_dtype="float32", compute_dtype="float32")
    gpu = Model(cfg, run).init(seed=0)
    cpu = Model(cfg, run, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    full = Model(cfg, run.with_(attn_impl="full"))
    full.load_state_dict(gpu.state_dict())
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(2, 40))
    got = gpu.forward({"tokens": toks})
    torch.testing.assert_close(got, full.forward({"tokens": toks}),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu.forward({"tokens": toks}),
                               atol=1e-4, rtol=1e-4)
    lg, caches = gpu.prefill({"tokens": toks}, 48)
    step, caches = gpu.decode_step({"tokens": toks[:, :1]}, caches)
    assert bool(torch.isfinite(step).all())
    assert caches["pos"].tolist() == [[41, 41]] * cfg.n_layers


@pytest.mark.parametrize("remat", ["nothing", "boundaries", "dots"])
def test_train_step_gradients_on_the_card_match_the_cpu(card, remat):
    """Reduced deepseek-7b, float32, blocked attention (blocks of 8 over 24
    tokens): the loss and every gradient of one step on the card, through
    the rmsnorm forward and backward kernels, against the plain path on the
    CPU. A layer under remat runs its two norms' forward again in the
    backward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("deepseek-7b").reduced()
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="blocked", remat=remat, attn_block_q=8,
                    attn_block_kv=8)
    gpu = Model(cfg, run).init(seed=0).trainable()
    cpu = Model(cfg, run, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    cpu.trainable()
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(2, 25))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fwd, bwd = rmsnorm.launches, rmsnorm_backward.launches
    loss, _, grads = loss_and_grads(gpu, gpu.params, batch)
    torch.cuda.synchronize()
    L = cfg.n_layers
    again = 0 if remat == "nothing" else 2 * L
    assert (rmsnorm.launches - fwd, rmsnorm_backward.launches - bwd) == \
        (2 * L + 1 + again, 2 * L + 1)
    want_loss, _, want = loss_and_grads(cpu, cpu.params, batch)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    flat = {}

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        else:
            flat[path] = (a.cpu(), b)

    walk(grads, want)
    for path, (got, ref) in flat.items():
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4,
                                   msg=path)



# -- Crispy's planner over the port: CUDAMemoryProfiler and HBMPlanner --------

MiB = 1024 ** 2


def test_memory_profiler_reads_a_256_mib_job(card):
    """A job that allocates 256 MiB and frees it reads a peak of 256 MiB
    (up to the allocator's rounding and 2 MiB besides), and the card's
    allocation is back at its base after the job."""
    from repro_torch.core.profiler import CUDAMemoryProfiler

    def job():
        torch.empty(256 * MiB, dtype=torch.uint8, device=card).fill_(1)

    prof = CUDAMemoryProfiler().profile(job, 1.0, card)
    assert 256 * MiB <= prof.job_mem_bytes <= 258 * MiB
    assert torch.cuda.memory_allocated(card) == prof.base_mem_bytes
    assert prof.reserved_mem_bytes >= prof.peak_mem_bytes
    assert prof.overhead_bytes > 0


def test_memory_profiler_raises_on_memory_left_behind(card):
    from repro_torch.core.profiler import CUDAMemoryProfiler
    kept = []
    with pytest.raises(RuntimeError, match="still allocated"):
        CUDAMemoryProfiler().profile(
            lambda: kept.append(torch.empty(MiB, device=card)), 1.0, card)
    del kept[:]


def test_reduced_dense_plan_is_confident_and_extrapolates(card):
    """The torch analogue of tests/test_planner.py's linearity test: a
    reduced deepseek-7b's train step, profiled over the depth ladder on the
    card, passes the R^2 gate, and the extrapolation lands within 10 % of
    the measured step at full (reduced) depth."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.hbm_planner import HBMPlanner

    cfg = get_arch("deepseek-7b").reduced(d_model=128, n_layers=24,
                                          vocab_size=512)
    run = RunConfig(attn_impl="full", remat="nothing",
                    param_dtype="float32", compute_dtype="float32")
    shape = ShapeConfig("train_128", 128, 4, "train")
    planner = HBMPlanner(leeway=0.0)
    rep = planner.plan(cfg, shape, card, run=run, anchor_layers=10,
                       select=False)
    assert rep.model.confident, f"R2={rep.model.r2}"
    truth = planner.profile_memory(cfg, shape, run, card)
    rel = abs(rep.predicted_per_dev_gib * 1024 ** 3 - truth) / truth
    assert rel < 0.10, f"extrapolation off by {rel:.2%}"


def test_gpu_profile_fn_answers_a_request_as_the_planner_does(card):
    """An allocation request whose profile_at is gpu_profile_fn: each
    point is the step's peak that HBMPlanner.profile_memory reads at that
    depth, to the byte, and the answer is the planner's requirement and
    selection over the same ladder."""
    from repro_torch.allocator import AllocationService
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.hbm_planner import (GPU_OVERHEAD_GIB, HBMPlanner,
                                              _reduced_depth, gpu_profile_fn)
    from repro_torch.core.history import ExecutionHistory
    from repro_torch.core.catalog import gpu_catalog
    from repro_torch.serve.engine import AllocationEndpoint

    cfg = get_arch("deepseek-7b").reduced(d_model=128, n_layers=24,
                                          vocab_size=512)
    run = RunConfig(attn_impl="full", remat="nothing",
                    param_dtype="float32", compute_dtype="float32")
    shape = ShapeConfig("prefill_128", 128, 4, "prefill")
    planner = HBMPlanner()
    profile_at = gpu_profile_fn(cfg, shape, run, card)
    r = profile_at(4.0)
    assert r.size == 4.0
    assert r.job_mem_bytes == planner.profile_memory(
        _reduced_depth(cfg, 4), shape, run, card)
    rep = planner.plan(cfg, shape, card, run=run)
    with AllocationService(gpu_catalog(), ExecutionHistory(),
                           overhead_per_node_gib=GPU_OVERHEAD_GIB,
                           leeway=planner.leeway) as svc:
        wire = AllocationEndpoint(svc).handle(
            timeout=300, job="reduced", profile_at=profile_at,
            sizes=planner.depth_ladder(cfg), full_size=cfg.n_layers)
    assert wire["requirement_gib"] == pytest.approx(rep.requirement_gib,
                                                    rel=1e-6)
    assert wire["config"] == rep.selection.config.name


@pytest.mark.parametrize("B,S", [(2, 2048), (1, 4096), (4, 1024)])
def test_a_ladder_on_the_held_cache_reads_the_cold_bytes(card, B, S):
    """deepseek-7b at full width, float32 AdamW, blocked attention, remat
    "boundaries" (the plan cell's job): each point of an answer, which
    begins on the cache its predecessor left, reads the bytes a profile
    alone reads at that depth, to the byte; the requirement and the
    selection follow; the answer leaves the card's reserve as it found it,
    after 4 warm points, 2 hand-backs, 1 collection and no retry of the
    allocator."""
    import gc
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.hbm_planner import HBMPlanner, _reduced_depth
    from repro_torch.telemetry.metrics import (MetricsRegistry,
                                               set_default_registry)
    cfg = get_arch("deepseek-7b")
    run = RunConfig(attn_impl="blocked", remat="boundaries",
                    param_dtype="float32", compute_dtype="float32")
    shape = ShapeConfig(f"train_b{B}_s{S}", S, B, "train")
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(card)
    registry = MetricsRegistry()
    previous = set_default_registry(registry)
    try:
        warm = HBMPlanner().plan(cfg, shape, card, run=run)
        counters = registry.snapshot()["counters"]
    finally:
        set_default_registry(previous)
    assert torch.cuda.memory_reserved(card) == reserved
    assert counters["planner.points_warm"] == 4
    assert counters["planner.cache_handbacks"] == 2
    assert counters["planner.gc_runs"] == 1
    assert counters["planner.alloc_retries"] == 0
    planner = HBMPlanner()
    cold = {d: planner.profile_memory(_reduced_depth(cfg, d), shape, run,
                                      card) for d in warm.ladder}
    print(f"B={B} S={S}: warm {warm.per_dev_bytes}, cold "
          f"{[cold[d] for d in warm.ladder]}")
    assert warm.per_dev_bytes == [cold[d] for d in warm.ladder]
    planner.profile_memory = lambda small, *args, **kwargs: \
        cold[small.n_layers]
    want = planner.plan(cfg, shape, card, run=run)
    assert warm.requirement_gib == want.requirement_gib
    assert warm.selection.config.scale_out == want.selection.config.scale_out
    assert warm.selection.config.name == want.selection.config.name


# -- the MoE family's training and the chunked AdamW update -------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_loss_gradients_give_the_same_bits_twice(card, arch):
    """A reduced MoE model (deepseek-v3-671b's with its MTP block), float32,
    blocked attention, 2 x 128 tokens: two backward passes of the loss (the
    dispatch's fixed-order backward, the rmsnorm backward kernel) give the
    same loss, terms and gradients to the bit, every one finite."""
    from repro_torch.optim.adamw import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).reduced()
    run = RunConfig(param_dtype="float32", compute_dtype="float32",
                    attn_impl="blocked", remat="nothing", attn_block_q=32,
                    attn_block_kv=32)
    gpu = Model(cfg, run).init(seed=0).trainable()
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, size=(2, 129))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    a = loss_and_grads(gpu, gpu.params, batch)
    b = loss_and_grads(gpu, gpu.params, batch)
    assert torch.equal(a[0], b[0]) and bool(torch.isfinite(a[0]))
    assert a[1].keys() == b[1].keys() and \
        all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    for x, y in zip(leaves(a[2]), leaves(b[2])):
        assert bool(torch.isfinite(x).all()) and torch.equal(x, y)


def test_f32_train_step_grows_by_16_bytes_a_parameter_a_layer(card):
    """deepseek-7b at full width, float32, B=2, S=2048, blocked attention,
    remat "boundaries" (the planner's train job): the step's peak grows by
    the state's 16 bytes a parameter (weights, gradients, m, v) a layer,
    within 5 %, between 4 and 12 layers, on either side of where the
    stacked MLP leaves outgrow the embedding. The AdamW update's
    temporaries are bounded by a chunk, not by the largest leaf."""
    from dataclasses import replace
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.profiler import CUDAMemoryProfiler
    from repro_torch.launch.dryrun import build_step
    from repro_torch.models.model import analytic_param_count
    run = RunConfig(attn_impl="blocked", remat="boundaries",
                    param_dtype="float32", compute_dtype="float32")
    shape = ShapeConfig("train_2048", 2048, 2, "train")
    peak, params = {}, {}
    for n in (4, 12):
        cfg = replace(get_arch("deepseek-7b"), n_layers=n)
        peak[n] = CUDAMemoryProfiler().profile(
            build_step(cfg, shape, run, card), n, card).job_mem_bytes
        params[n] = analytic_param_count(cfg)
    want = 16 * (params[12] - params[4])
    got = peak[12] - peak[4]
    print(f"peak at 4 layers {peak[4] / 2 ** 30:.4f} GiB, at 12 "
          f"{peak[12] / 2 ** 30:.4f} GiB; growth {got / want:.4f} x 16 B a "
          f"parameter")
    assert abs(got - want) / want < 0.05


def _gloo_rank(rank, store, conn):
    """A rank of a two-rank gloo world on the one card: every collective of
    the port on CUDA tensors, float32 and bfloat16, against the values the
    ranks put in."""
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import make_mesh, shutdown
    from repro_torch.sharding import collectives as C
    torch.cuda.set_device(0)
    mesh = make_mesh(MeshConfig((1, 2), ("data", "model")), "gloo", "cuda",
                     init_method=f"file://{store}", rank=rank, timeout_s=60)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((4, 6), float(rank + 1), device="cuda", dtype=dtype)
        name = str(dtype)
        out[name] = {
            "all_reduce": C.all_reduce(x, mesh, "model")[0, 0].item(),
            "all_gather": C.all_gather(x, mesh, "model", 1)[0].tolist(),
            "reduce_scatter": C.reduce_scatter(x, mesh, "model",
                                               0).sum().item(),
            "all_to_all": C.all_to_all(
                torch.stack([x[:2] * 10, x[2:]]), mesh, "model")[:, 0, 0]
            .tolist(),
            "ppermute": C.ppermute(x, mesh, "model")[0, 0].item()}
    out["staged"] = C.stats()["host_staged"]["calls"]
    conn.send(out)
    shutdown(mesh)


def test_collectives_over_gloo_on_the_card(card, tmp_path):
    """Two ranks share the card over gloo: each collective gives the right
    values on CUDA tensors; those gloo does not take there (ppermute, and
    every collective of bfloat16) are staged through host memory."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    for rank in range(2):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_gloo_rank, daemon=True, args=(
            rank, str(tmp_path / "store"), child))
        proc.start()
        procs.append(proc)
        conns.append(parent)
    got = []
    for conn in conns:
        assert conn.poll(180), "a rank gave no answer"
        got.append(conn.recv())
    for proc in procs:
        proc.join(60)
        assert proc.exitcode == 0
    for rank, out in enumerate(got):
        for name in (str(torch.float32), str(torch.bfloat16)):
            r = out[name]
            assert r["all_reduce"] == 3.0
            assert r["all_gather"] == [1.0] * 6 + [2.0] * 6
            assert r["reduce_scatter"] == 3.0 * 12
            # block j went to rank j: rank 0 gets the blocks of 10s
            want = [10.0, 20.0] if rank == 0 else [1.0, 2.0]
            assert r["all_to_all"] == want
            assert r["ppermute"] == float(2 - rank)
        assert out["staged"] > 0


def test_a_rank_alone_steps_on_the_card(card):
    """Rank 0 of a (1, 2) mesh run alone: its train step runs on the card
    through the rmsnorm kernels, at half the heads, ff and vocabulary."""
    from repro_torch.configs import MeshConfig, ShapeConfig
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.mesh import Mesh
    cfg = get_arch("deepseek-7b").reduced(d_model=256, n_heads=4,
                                          n_kv_heads=4, d_head=64)
    mesh = Mesh.alone(MeshConfig((1, 2), ("data", "model")), 0)
    before = rmsnorm_backward.launches
    build_step(cfg, ShapeConfig("train_64", 64, 2, "train"),
               RunConfig(attn_impl="blocked", compute_dtype="float32"),
               mesh=mesh)()
    torch.cuda.synchronize()
    assert rmsnorm_backward.launches > before


# the three layouts of a 'model' axis that take neither the KV heads nor
# the positions as they are split elsewhere: (arch, MoE impl, mesh, cache
# positions, int8 cache)
LAYOUTS = {"int8_by_positions": ("deepseek-7b", None, (1, 4), 16, True),
           "whole_cache": ("deepseek-7b", None, (1, 4), 14, False),
           "moe_dense": ("olmoe-1b-7b", "dense", (1, 2), 16, False)}
LAYOUT_STEPS, LAYOUT_PROMPT = 4, 6


def _layout_cfg(arch, impl):
    from dataclasses import replace
    cfg = get_arch(arch).reduced(n_layers=2)
    if impl is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, impl=impl))
    return cfg


def _serve_layout(model, prompt, max_len, quant, steps=None):
    """Prefill (its caches quantized to int8 for `quant`), then LAYOUT_STEPS decode steps (fed `steps`, else the
    greedy tokens): [prefill logits, each step's logits], the tokens fed."""
    lg, caches = model.prefill({"tokens": prompt}, max_len)
    if quant:
        caches = quantize_caches(caches)
    out, fed = [lg.float().cpu()], []
    for i in range(LAYOUT_STEPS):
        tok = steps[i] if steps is not None else \
            lg[:, -1, :model.cfg.vocab_size].argmax(-1)[:, None].cpu()
        fed.append(tok)
        lg, caches = model.decode_step({"tokens": tok}, caches)
        out.append(lg.float().cpu())
    return out, fed


def _layout_rank(rank, layout, store, params, prompt, steps, conn):
    """A rank of the layout's gloo world on the card: its blocks of the
    weights, its logits blocks."""
    from repro_torch.configs import MeshConfig
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.launch.mesh import make_mesh, shutdown
    arch, impl, shape, max_len, quant = LAYOUTS[layout]
    torch.cuda.set_device(0)
    mesh = make_mesh(MeshConfig(shape, ("data", "model")), "gloo", "cuda",
                     init_method=f"file://{store}", rank=rank, timeout_s=120)
    run = RunConfig(attn_impl="kernel", compute_dtype="float32")
    model = Model(_layout_cfg(arch, impl), run, "cuda", mesh)
    params_from_numpy(shard_params(params, model.specs, mesh), model)
    out, _ = _serve_layout(model, prompt, max_len, quant, steps)
    conn.send([t.numpy() for t in out])
    shutdown(mesh)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_serving_layouts_on_the_card(card, tmp_path, layout):
    """deepseek-7b's int8 cache split by positions and its whole cache
    (positions that do not divide) on (1, 4), olmoe-1b-7b's MoE impl
    "dense" on (1, 2), reduced, float32: gloo ranks sharing the card
    against the one-device path on the card, logits within 1e-4 (int8:
    1e-3), the greedy tokens the one-device path fed equal."""
    import multiprocessing
    from repro_torch.convert import params_to_numpy
    from repro_torch.sharding import rules
    arch, impl, shape, max_len, quant = LAYOUTS[layout]
    cfg = _layout_cfg(arch, impl)
    run = RunConfig(attn_impl="kernel", compute_dtype="float32")
    one = Model(cfg, run, "cuda").init(seed=0)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, LAYOUT_PROMPT)).astype(np.int32))
    want, fed = _serve_layout(one, prompt, max_len, quant)
    params = params_to_numpy(one)
    del one
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    for rank in range(shape[0] * shape[1]):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_layout_rank, daemon=True, args=(
            rank, layout, str(tmp_path / "store"), params, prompt, fed, child))
        proc.start()
        procs.append(proc)
        conns.append(parent)
    got = []
    for conn in conns:
        assert conn.poll(600), "a rank gave no answer"
        got.append(conn.recv())
    for proc in procs:
        proc.join(60)
        assert proc.exitcode == 0
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.configs import MeshConfig
    mshape = MeshShape(MeshConfig(shape, ("data", "model")))
    tol = 1e-3 if quant else 1e-4
    V = cfg.vocab_size
    for i, w in enumerate(want):
        g = rules.gather_tensor([r[i] for r in got], (None, None, "model"),
                                mshape)
        np.testing.assert_allclose(g, w.numpy(), atol=tol, rtol=tol)
        np.testing.assert_array_equal(g[:, -1, :V].argmax(-1),
                                      w[:, -1, :V].argmax(-1).numpy())


# ---------------------------------------------------------------------------
# the kernels at a rank's shapes of the sharded paths (chip_smoke.py's
# SHARD_FLASH and SHARD_RECURRENT)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal", [
    (4, 2048, 2048, 16, 16, 112, True),      # zamba2-7b's shared block, 1 of 2
    (4, 1500, 1500, 6, 6, 64, False),        # whisper-small's encoder
    (4, 448, 448, 6, 6, 64, True),           # its decoder's self-attention
    (4, 448, 1500, 6, 6, 64, False),         # its cross-attention
    (4, 1, 1500, 6, 6, 64, False),           # and a tick's
    (4, 2048, 2048, 64, 64, 192, True),      # deepseek-v3-671b's MLA
    (4, 2048, 2048, 8, 8, 128, True),        # olmoe-1b-7b
    (2, 2048, 2048, 32, 32, 128, True),      # deepseek-7b's rows of (2, 1)
    (4, 2048, 2048, 12, 1, 128, True)])      # mistral-large-123b of (1, 8)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_a_ranks_shapes(card, B, Sq, Sk, H, Hkv, D,
                                                  causal, dtype):
    """A rank's heads of (1, 2) (or rows of (2, 1)): the kernel against the
    plain version; k and v are views of buffers whose rows past Sk hold
    NaN, which the output must not see."""
    q = randn(card, 30, (B, Sq, H, D), dtype)
    k, v = (randn(card, seed, (B, Sk + 64, Hkv, D), dtype).index_fill_(
        1, torch.arange(Sk, Sk + 64, device=card), float("nan"))[:, :Sk]
        for seed in (31, 32))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert_close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("S,with_state", [(2048, False), (1, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_at_a_ranks_heads(card, S, with_state, dtype):
    """rwkv6-7b's prefill and decode tick at a rank's 32 of its 64 heads,
    with its decay (w0 = -0.6 plus a small data-dependent term), against
    the plain version; the tick's state written in place."""
    B, H, K = 4, 32, 64
    r, k, v = (randn(card, 70 + i, (B, S, H, K), dtype) for i in range(3))
    lw = -torch.exp(-0.6 + 0.5 * randn(card, 73, (B, S, H, K), torch.float32))
    u = 0.1 * randn(card, 74, (H, K), torch.float32)
    state = randn(card, 75, (B, H, K, K), torch.float32) if with_state \
        else None
    start = None if state is None else state.clone()
    y, st = wkv6(r, k, v, lw, u, state=state, state_out=state)
    want_y, want_st = wkv6_plain(r, k, v, lw, u, state=start)
    atol, rtol = WKV_TOL[dtype]
    torch.cuda.synchronize()
    assert st is state if with_state else True
    torch.testing.assert_close(y, want_y, atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_a_ranks_heads(card, dtype):
    """zamba2-7b's prefill at a rank's 56 of its 112 heads, one group of B
    and C, mamba2's dt and A: the kernel against the plain version at its
    tile."""
    B, S, H, P, N = 4, 2048, 56, 64, 64
    xs, dt, A, _, _ = ssd_inputs(card, B, S, H, P, N, dtype, seed=80)
    bg, cg = (randn(card, 90 + i, (B, S, 1, N), dtype) for i in range(2))
    Bx, Cx = bg.expand(B, S, H, N), cg.expand(B, S, H, N)
    got, _ = ssd(xs, dt, A, Bx, Cx)
    want, _ = ssd_plain(xs, dt, A, Bx, Cx, chunk=TILE)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# the dry-run tooling on the card
# ---------------------------------------------------------------------------


def test_a_kernel_launch_counts_what_its_plain_version_counts(card):
    """Under launch.costs a flash attention, wkv6 and ssd launch on the card
    add what their plain versions' products count: a step that runs the
    kernels counts what the plain path counts."""
    from repro_torch.launch import costs as K
    from repro_torch.kernels.flash_attention import flash_attention_plain
    q = randn(card, 100, (2, 128, 8, 64), torch.bfloat16)
    k = randn(card, 101, (2, 128, 2, 64), torch.bfloat16)
    _, got = K.count(lambda: flash_attention(q, k, k, causal=True))
    _, want = K.count(lambda: flash_attention_plain(q, k, k, causal=True))
    assert (got.dot_flops, got.dot_bytes) == (want.dot_flops, want.dot_bytes)
    assert got.kernels["flash_attention"]["launches"] == 1
    r = randn(card, 102, (2, 40, 4, 64), torch.bfloat16)
    lw = -torch.exp(randn(card, 103, (2, 40, 4, 64), torch.float32))
    u = randn(card, 104, (4, 64), torch.float32)
    _, got = K.count(lambda: wkv6(r, r, r, lw, u))
    _, want = K.count(lambda: wkv6_plain(r, r, r, lw, u))
    assert (got.dot_flops, got.dot_bytes) == (want.dot_flops, want.dot_bytes)
    xs, dt, A, Bm, Cm = ssd_inputs(card, 2, 100, 4, 64, 64, torch.bfloat16,
                                   seed=105)
    _, got = K.count(lambda: ssd(xs, dt, A, Bm, Cm))
    _, want = K.count(lambda: ssd_plain(xs, dt, A, Bm, Cm))
    assert (got.dot_flops, got.dot_bytes) == (want.dot_flops, want.dot_bytes)


def test_run_cell_on_a_rank_of_the_production_mesh(card):
    """run_cell of mistral-large-123b cut to 2 layers at full width,
    prefill_32k, on rank 0 alone of (16, 16): the reference's fields, the
    peak measured over the arguments, the roofline's terms."""
    from dataclasses import replace
    from repro_torch.configs import SHAPES, SINGLE_POD
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.presets import preset_run
    cfg = get_arch("mistral-large-123b")
    run = preset_run(cfg, SHAPES["prefill_32k"], SINGLE_POD)  # fsdp_params
    rec = run_cell(replace(cfg, n_layers=2), SHAPES["prefill_32k"],
                   SINGLE_POD, run, device=card)
    m, r = rec["memory"], rec["roofline"]
    print(rec)
    assert rec["n_devices"] == 256 and rec["device"].startswith("NVIDIA")
    assert m["peak_bytes"] > m["argument_bytes"] > 0
    assert m["temp_bytes"] == m["peak_bytes"] - m["argument_bytes"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert 0 < r["useful_flops_fraction"] <= 1.0
    assert rec["collectives"]["counts"]["all-gather"] > 0     # fsdp_params


def test_mesh_advisor_plans_a_rank_and_checks_it_at_full_depth(card):
    """examples/mesh_advisor_torch.py: mistral-large-123b's decode_32k over
    the (16, 16) profile mesh, the ladder profiled, the fit extrapolated to
    88 layers, a selection, and rank 0 measured there within 10 %."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "mesh_advisor_torch.py"
    spec = importlib.util.spec_from_file_location("mesh_advisor_torch", path)
    advisor = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(advisor)
    rep, truth = advisor.main(["--arch", "mistral-large-123b", "--shape",
                               "decode_32k", "--mesh", "16x16"])
    assert rep.model.confident and rep.selection is not None
    assert truth is not None
    pred = rep.model.predict(88)
    assert abs(pred - truth) / truth < 0.10
