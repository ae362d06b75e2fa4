"""The plain versions of the port's kernels against the Pallas kernel bodies
of the JAX package (interpret mode on the CPU), on the same numpy inputs; and
the wrappers' contract. The CUDA kernels themselves are held against the
plain versions on the card by chip_smoke.py."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models.layers import rms_norm as jax_rms_norm

import repro_torch
from repro_torch.configs import ARCHS
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 kernel_strides)
from repro_torch.kernels.rmsnorm import (BLOCK_THREADS, MAX_VECTORS,
                                        ROW_THREADS, launch_shape, rmsnorm,
                                        rmsnorm_backward,
                                        rmsnorm_backward_plain, rmsnorm_plain)
from repro_torch.kernels.ssd import p_block
from repro_torch.kernels.wkv6 import HEAD_DIMS, _kernel_checks, wkv6
from test_torch_parity import as_f32, to_jax, to_torch


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (1, 32, 32, 2, 2, 16),
    (2, 64, 64, 4, 2, 32),
    (1, 96, 48, 4, 1, 64),     # ragged + MQA
    (2, 33, 65, 2, 2, 16),     # non-divisible block sizes
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(B, Sq, Sk, H, Hkv, D, causal,
                                              dtype):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D), dtype=np.float32)
    want = ops.flash_attention(to_jax(q, dtype), to_jax(k, dtype),
                               to_jax(v, dtype), causal=causal, block_q=32,
                               block_kv=16)
    got = flash_attention_plain(to_torch(q, dtype), to_torch(k, dtype),
                                to_torch(v, dtype), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **tol(dtype))


@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 96), (2, 5, 7, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape, dtype=np.float32)
    sc = 1.0 + 0.1 * rng.standard_normal(shape[-1:], dtype=np.float32)
    want = ops.rmsnorm(to_jax(x, dtype), jnp.asarray(sc), block_rows=4)
    got = rmsnorm_plain(to_torch(x, dtype), to_torch(sc))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_residual_matches_pallas(dtype):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 64), dtype=np.float32)
    r = rng.standard_normal((8, 64), dtype=np.float32)
    sc = np.ones((64,), np.float32)
    want = ops.rmsnorm(to_jax(x, dtype), jnp.asarray(sc),
                       residual=to_jax(r, dtype), block_rows=8)
    got = rmsnorm_plain(to_torch(x, dtype), to_torch(sc),
                        residual=to_torch(r, dtype))
    np.testing.assert_allclose(as_f32(got), as_f32(want), **tol(dtype))


@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 96), (2, 5, 7, 128)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_backward_plain_matches_jax_grad(shape, residual):
    """dx, dscale (and the residual's gradient, which is dx) against
    jax.vjp of the reference's rms_norm over x [+ residual], float32."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape, dtype=np.float32)
    r = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    sc = 1.0 + 0.1 * rng.standard_normal(shape[-1:], dtype=np.float32)

    def f(x, r, sc):
        return jax_rms_norm(x + r if residual else x, sc)

    _, vjp = jax.vjp(f, to_jax(x), to_jax(r), to_jax(sc))
    want_dx, want_dr, want_ds = vjp(to_jax(g))
    dx, ds = rmsnorm_backward_plain(to_torch(x), to_torch(sc), to_torch(g),
                                    residual=to_torch(r) if residual else None)
    np.testing.assert_allclose(as_f32(dx), as_f32(want_dx), **tol("float32"))
    np.testing.assert_allclose(as_f32(ds), as_f32(want_ds), **tol("float32"))
    if residual:
        np.testing.assert_allclose(as_f32(dx), as_f32(want_dr),
                                   **tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_backward_plain_matches_autograd(dtype, residual):
    """The plain backward against autograd of rmsnorm_plain, which is what
    the wrapper gives a CPU tensor under autograd; the wrapper of the
    backward takes the plain version there and counts no launch."""
    rng = np.random.default_rng(12)
    shape = (3, 5, 64)
    x, r, g = (to_torch(rng.standard_normal(shape, dtype=np.float32), dtype)
               for _ in range(3))
    sc = to_torch(1.0 + 0.1 * rng.standard_normal((64,), dtype=np.float32))
    xs = x.clone().requires_grad_()
    rs = r.clone().requires_grad_() if residual else None
    scs = sc.clone().requires_grad_()
    rmsnorm(xs, scs, residual=rs).backward(g)
    before = rmsnorm_backward.launches
    dx, ds = rmsnorm_backward(x, sc, g, residual=r if residual else None)
    assert rmsnorm_backward.launches == before
    assert torch.equal(dx, rmsnorm_backward_plain(
        x, sc, g, residual=r if residual else None)[0])
    np.testing.assert_allclose(as_f32(dx), as_f32(xs.grad), **tol(dtype))
    np.testing.assert_allclose(as_f32(ds), as_f32(scs.grad), **tol(dtype))
    if residual:
        np.testing.assert_allclose(as_f32(dx), as_f32(rs.grad), **tol(dtype))


def test_flash_attention_plain_fully_visible_first_row():
    """Causal with Sq > Skv is aligned top-left: row 0 sees key 0 only."""
    rng = np.random.default_rng(9)
    q = to_torch(rng.standard_normal((1, 8, 2, 16), dtype=np.float32))
    k = to_torch(rng.standard_normal((1, 4, 2, 16), dtype=np.float32))
    v = to_torch(rng.standard_normal((1, 4, 2, 16), dtype=np.float32))
    out = flash_attention_plain(q, k, v, causal=True)
    np.testing.assert_allclose(as_f32(out[:, 0]), as_f32(v[:, 0]), atol=1e-6)


# ---------------------------------------------------------------------------
# the wrappers' contract
# ---------------------------------------------------------------------------


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(10)
    x = to_torch(rng.standard_normal((5, 64), dtype=np.float32))
    sc = to_torch(rng.standard_normal((64,), dtype=np.float32))
    q = to_torch(rng.standard_normal((1, 8, 2, 16), dtype=np.float32))
    before = (rmsnorm.launches, flash_attention.launches)
    assert torch.equal(rmsnorm(x, sc), rmsnorm_plain(x, sc))
    assert torch.equal(rmsnorm(x, sc, residual=x),
                       rmsnorm_plain(x, sc, residual=x))
    assert torch.equal(flash_attention(q, q, q, causal=True),
                       flash_attention_plain(q, q, q, causal=True))
    assert (rmsnorm.launches, flash_attention.launches) == before


def test_kernel_strides_give_tma_a_multiple_of_16_bytes():
    """The stride of a dimension of size 1 becomes the span of the dimension
    inside it, so that every stride the bfloat16 kernel's TMA maps see is a
    multiple of 16 bytes; the other strides pass unchanged."""
    S, H, D = 5, 3, 112
    odd = torch.empty(S * H * D, dtype=torch.bfloat16).as_strided(
        (1, S, H, D), (7, H * D, D, 1))
    assert kernel_strides(odd) == (S * H * D, H * D, D)
    bhsd = torch.empty((2, H, S, D)).transpose(1, 2)       # (B, S, H, D) view
    assert kernel_strides(bhsd) == bhsd.stride()[:3]
    one_row = torch.empty(300, dtype=torch.bfloat16).as_strided(
        (2, 1, 1, 128), (136, 3, 5, 1))
    assert kernel_strides(one_row) == (136, 128, 128)
    for t in (odd, bhsd, one_row):
        assert all(s * t.element_size() % 16 == 0 for s in kernel_strides(t))


def test_wrappers_refuse_what_does_not_fit():
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones((32,)))
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones((64,)), residual=torch.zeros((4, 32)))
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError):                 # H % Hkv != 0
        flash_attention(q, torch.zeros((1, 8, 3, 16)),
                        torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError):                 # dtypes differ
        flash_attention(q, q.bfloat16(), q.bfloat16())


def test_kernel_package_imports_without_nvcc_or_card(monkeypatch):
    """Importing compiles nothing; the build is asked for only when a CUDA
    tensor arrives, and says what is missing when it cannot be made."""
    import repro_torch.kernels  # noqa: F401
    assert build._lib is None
    assert {p.name for p in build.sources()} == {"rmsnorm.cu",
                                                 "flash_attention.cu",
                                                 "wkv6.cu", "ssd.cu"}
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    if not Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(build.KernelBuildError, match="nvcc not found"):
            build.find_nvcc()


def test_default_device_is_the_gpu_and_raises_without_one():
    if torch.cuda.is_available():
        assert repro_torch.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.resolve_device(None)
    assert repro_torch.resolve_device("cpu").type == "cpu"


def test_rmsnorm_wrapper_still_checks_its_arguments_on_cpu_tensors():
    """The trimmed per-call path keeps every check that rejects a wrong
    argument, and makes them before a CPU tensor goes to the plain version."""
    x = torch.zeros((4, 64))
    sc = torch.ones((64,))
    with pytest.raises(ValueError, match="does not match"):
        rmsnorm(x, torch.ones((4, 64)))
    for bad in (torch.zeros((4, 32)), torch.zeros((4, 64), dtype=torch.bfloat16),
                torch.zeros((4, 64), device="meta")):
        with pytest.raises(ValueError, match="residual must match"):
            rmsnorm(x, sc, residual=bad)
    with pytest.raises(ValueError, match="scale on meta"):
        rmsnorm(x, torch.ones((64,), device="meta"))
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        rmsnorm(x.half(), sc)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        rmsnorm(x, sc.double())
    assert build.DTYPE_CODES == {torch.float32: 0, torch.bfloat16: 1}


def _norm_widths():
    """Every width a norm of the port's configurations sees, full and
    reduced: d_model, the Mamba2 block's inner width (ssm_norm), and MLA's
    two latent ranks (q_norm, kv_norm)."""
    widths = set()
    for cfg in ARCHS.values():
        for c in (cfg, cfg.reduced()):
            widths.add(c.d_model)
            if c.family == "hybrid":
                widths.add(c.ssm.expand * c.d_model)
            if c.mla is not None:
                widths |= {c.mla.q_lora_rank, c.mla.kv_lora_rank}
    return sorted(widths)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_rmsnorm_launch_shape_leaves_no_lane_idle(itemsize):
    """Every norm width of the configurations, bf16 and f32, gets a register
    kernel shape whose threads each hold the same number of whole 16-byte
    vectors, within the kernel's limits; in bf16, 3584, 4096, 7168 and 12288
    get 64 x 7, 64 x 8, 128 x 7 and 256 x 6."""
    per16 = 16 // itemsize
    for d in _norm_widths():
        shape = launch_shape(d, itemsize)
        assert shape is not None, d
        threads, vectors, rows = shape
        assert threads & (threads - 1) == 0 and threads <= ROW_THREADS
        assert 1 <= vectors <= MAX_VECTORS
        assert threads * vectors * per16 == d
        assert threads * rows == max(threads, BLOCK_THREADS)
    if itemsize == 2:
        assert [launch_shape(d, 2)[:2] for d in (3584, 4096, 7168, 12288)] == \
            [(64, 7), (64, 8), (128, 7), (256, 6)]
    # no whole vectors, or more than a row of threads can hold: the
    # shared-memory kernel
    assert launch_shape(70, itemsize) is None
    assert launch_shape(20000, itemsize) is None


def test_ssd_p_block_leaves_no_column_idle():
    """The bf16 ssd kernel's blocks along P cover the head width of every
    configuration with an SSM with no padded column."""
    for cfg in ARCHS.values():
        for c in (cfg, cfg.reduced()):
            if c.ssm is None:
                continue
            P = c.ssm.head_dim
            assert p_block(P) in (16, 32) and P % p_block(P) == 0, c.name
    assert [p_block(P) for P in (8, 16, 17, 32, 40, 64)] == [16, 16, 32, 32, 32, 32]


def test_wkv6_kernels_take_every_head_size_with_no_idle_lane():
    """Every configuration with the wkv recurrence has a head size the
    kernels take. Each K they take fills whole mma tiles of 8 value columns
    (one a warp of the bf16 kernel, K / 8 warps at K = 64), and the full
    size's (64) fills the 32 lanes of a warp in A with K / 32 channels each;
    bfloat16 takes the bf16 kernel, float32 the float32 one."""
    for cfg in ARCHS.values():
        for c in (cfg, cfg.reduced()):
            if c.family == "ssm":
                assert c.d_head in HEAD_DIMS, c.name
        if cfg.family == "ssm":
            assert cfg.d_head % 32 == 0, cfg.name
    for K in HEAD_DIMS:
        assert K % 8 == 0 and K <= 64, K
        r = torch.zeros((1, 2, 1, K))
        args = (torch.zeros((1, 2, 1, K)), torch.zeros((1, K)), None, None)
        assert _kernel_checks(r, r, r, *args) == build.DTYPE_CODES[torch.float32]
        rb = r.bfloat16()
        assert _kernel_checks(rb, rb, rb, *args) == \
            build.DTYPE_CODES[torch.bfloat16]


def test_wkv6_kernel_checks_refuse_what_the_kernels_do_not_take():
    """What the kernels take beyond the contract, checked before a launch:
    the dtype code each dtype takes, and a raise on a non-unit last stride,
    a K or dtype the kernels lack, an empty input, a strided u or state."""
    B, S, H, K = 1, 5, 2, 16
    r = torch.zeros((B, S, H, K))
    lw, u = torch.zeros((B, S, H, K)), torch.zeros((H, K))
    st = torch.zeros((B, H, K, K))
    assert _kernel_checks(r, r, r, lw, u, st, st) == 0
    rb = r.bfloat16()
    assert _kernel_checks(rb, rb, rb, lw, u, None, None) == 1
    wide = torch.zeros((B, S, H, 2 * K))[..., ::2]
    for name, args in (("r", (wide, r, r, lw)), ("k", (r, wide, r, lw)),
                       ("v", (r, r, wide, lw)), ("lw", (r, r, r, wide))):
        with pytest.raises(ValueError, match=f"{name} needs a contiguous last"):
            _kernel_checks(*args, u, None, None)
    with pytest.raises(ValueError, match="K in"):
        r12 = torch.zeros((B, S, H, 12))
        _kernel_checks(r12, r12, r12, r12, torch.zeros((H, 12)), None, None)
    with pytest.raises(ValueError, match="empty"):
        r0 = torch.zeros((B, 0, H, K))
        _kernel_checks(r0, r0, r0, r0, u, None, None)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        _kernel_checks(r.half(), r.half(), r.half(), lw, u, None, None)
    with pytest.raises(TypeError, match="float32 lw"):
        _kernel_checks(r, r, r, lw.bfloat16(), u, None, None)
    with pytest.raises(ValueError, match="state must be contiguous"):
        _kernel_checks(r, r, r, lw, u, st.transpose(2, 3), None)
    # and the contract itself, before the CPU takes the plain version
    with pytest.raises(ValueError, match="different devices"):
        wkv6(r, r, r, lw, u.to("meta"))
    with pytest.raises(ValueError, match="u "):
        wkv6(r, r, r, lw, torch.zeros((H, K + 1)))
    with pytest.raises(ValueError, match="state_out"):
        wkv6(r, r, r, lw, u, state_out=torch.zeros((B, H, K, K - 1)))
