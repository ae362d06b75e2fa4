"""Tests that need the card: the CUDA kernels against their plain versions,
and the model's kernel path against its plain path. Skipped where there is
no GPU; on the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_arch
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.models import Model

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (1, 32, 32, 2, 2, 16), (2, 64, 64, 4, 2, 32), (1, 96, 48, 4, 1, 64),
    (2, 33, 65, 2, 2, 16), (1, 200, 130, 8, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(card, B, Sq, Sk, H, Hkv, D, causal, dtype):
    q = randn(card, 0, (B, Sq, H, D), dtype)
    k = randn(card, 1, (B, Sk, Hkv, D), dtype)
    v = randn(card, 2, (B, Sk, Hkv, D), dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert_close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


def test_flash_attention_kernel_reads_strided_views(card):
    """q, k, v as slices of one fused projection: strides, no copy."""
    B, S, H, D = 2, 70, 4, 64
    qkv = randn(card, 3, (B, S, 3, H, D), torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    assert_close(flash_attention(q, k, v, causal=True),
                 flash_attention_plain(q, k, v, causal=True), torch.bfloat16)


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
    got = rmsnorm(x, sc, residual=r)
    assert rmsnorm.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert_close(got, rmsnorm_plain(x, sc, residual=r), dtype)


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
