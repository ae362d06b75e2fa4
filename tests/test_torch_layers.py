"""Layer primitives of the port against repro.models.layers on the same
numpy inputs, float32 at 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.models import layers as TL
from test_torch_parity import as_f32, to_jax, to_torch

TOL = dict(atol=1e-5, rtol=1e-5)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", [(4, 64), (2, 7, 96)])
def test_rms_norm(shape):
    x, sc = randn(0, *shape), 1.0 + 0.1 * randn(1, shape[-1])
    want = JL.rms_norm(to_jax(x), to_jax(sc), 1e-5)
    got = TL.rms_norm(to_torch(x), to_torch(sc), 1e-5)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


@pytest.mark.parametrize("kind,fraction", [("full", 1.0), ("partial", 0.5),
                                           ("2d", 0.5), ("none", 1.0)])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_rotary(kind, fraction, batched_positions):
    B, S, H, D = 2, 9, 3, 16
    x = randn(2, B, S, H, D)
    if batched_positions:
        pos = np.random.default_rng(3).integers(0, 500, size=(B, S))
    else:
        pos = np.arange(S) + 5
    want = JL.rotary(to_jax(x), jnp.asarray(pos), kind, fraction, 10000.0)
    got = TL.rotary(to_torch(x), torch.from_numpy(pos), kind, fraction,
                    10000.0)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


def test_rotary_rotates_interleaved_pairs():
    """Pairs are (x[0], x[1]), (x[2], x[3]) ..., not the two halves."""
    x = np.zeros((1, 1, 1, 4), np.float32)
    x[..., 0] = 1.0
    got = TL.rotary(to_torch(x), torch.tensor([1]), "full", 1.0, 10000.0)
    want = np.array([np.cos(1.0), np.sin(1.0), 0.0, 0.0], np.float32)
    np.testing.assert_allclose(as_f32(got)[0, 0, 0], want, atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp(kind):
    d, ff = 32, 48
    params = {"up": randn(4, d, ff) / np.sqrt(d),
              "down": randn(5, ff, d) / np.sqrt(ff)}
    if kind == "swiglu":
        params["gate"] = randn(6, d, ff) / np.sqrt(d)
    x = randn(7, 2, 5, d)
    want = JL.mlp({k: to_jax(v) for k, v in params.items()}, to_jax(x), kind)
    got = TL.mlp({k: to_torch(v) for k, v in params.items()}, to_torch(x),
                 kind)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


def test_mlp_unknown_kind_raises():
    with pytest.raises(ValueError):
        TL.mlp({"up": torch.zeros(2, 2), "down": torch.zeros(2, 2)},
               torch.zeros(1, 1, 2), "tanh")


def test_embed():
    table = randn(8, 50, 16)
    ids = np.random.default_rng(9).integers(0, 50, size=(2, 6))
    want = JL.embed(to_jax(table), jnp.asarray(ids), jnp.float32)
    got = TL.embed(to_torch(table), torch.from_numpy(ids), torch.float32)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=0, rtol=0)
    assert TL.embed(to_torch(table), torch.from_numpy(ids),
                    torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_logits(layout):
    V, d = 50, 16
    w = randn(10, V, d) if layout == "vd" else randn(10, d, V)
    x = randn(11, 2, 3, d)
    want = JL.logits(to_jax(w), to_jax(x))
    got = TL.logits(to_torch(w), to_torch(x))
    assert tuple(got.shape) == (2, 3, V)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


def test_dense_init_is_a_truncated_normal_from_its_generator():
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (256, 64))
    std = 1.0 / np.sqrt(256)
    assert float(w.abs().max()) <= 2.0 * std + 1e-7
    assert 0.8 * std < float(w.std()) < 0.95 * std      # ~0.88 sigma
    again = TL.dense_init(torch.Generator().manual_seed(0), (256, 64))
    assert torch.equal(w, again)
    wo = TL.dense_init(gen, (4, 16, 64), in_axis_size=64, dtype=torch.bfloat16)
    assert wo.dtype == torch.bfloat16
    assert float(wo.float().abs().max()) <= 2.0 / 8.0 + 1e-3
