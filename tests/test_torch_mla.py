"""Multi-head latent attention (deepseek-v3-671b reduced) in the port against
the JAX package, float32 on the CPU, on the same numpy inputs and on weights
carried across: ``mla`` through each softmax core, ``mla_prefill`` and its
latent caches, ``mla_decode`` over the absorbed cache, and flash attention's
plain version at MLA's head dim 192 against the Pallas kernel in interpret
mode. Tolerances are the reference's own (tests/test_kernels.py,
tests/test_models.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops
from repro.models import attention as JA

from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention_plain
from repro_torch.models import attention as TA
from test_torch_parity import as_f32, jax_run, to_jax, to_torch, torch_run

ARCH = "deepseek-v3-671b"
B, S = 2, 9
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
MODEL = dict(atol=1e-4, rtol=1e-4)


def randn(seed, *shape, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


@pytest.fixture(scope="module")
def mla_pair():
    """(jax config, port config, numpy MLA weights, the same as tensors)."""
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    tree = jax.tree.map(np.asarray, JA.init_mla(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree, jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_dim_192(causal, dtype):
    """deepseek-v3's MLA core: q and k of 128 + 64 columns, v padded to
    them; the kernel takes D = 192."""
    assert 192 in HEAD_DIMS
    q, k, v = (randn(70 + i, 1, 40, 2, 192) for i in range(3))
    v[..., 128:] = 0.0
    want = ops.flash_attention(to_jax(q, dtype), to_jax(k, dtype),
                               to_jax(v, dtype), causal=causal, block_q=16,
                               block_kv=16)
    got = flash_attention_plain(to_torch(q, dtype), to_torch(k, dtype),
                                to_torch(v, dtype), causal=causal)
    np.testing.assert_allclose(as_f32(got), as_f32(want),
                               **(F32 if dtype == "float32" else BF16))


def test_init_mla_has_the_references_leaves(mla_pair):
    jcfg, cfg, tree, _ = mla_pair
    got = TA.init_mla(torch.Generator().manual_seed(0), cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in tree.items()}
    assert float(got["q_norm"].min()) == 1.0 == float(got["kv_norm"].max())
    # no shape is sized from the config's d_head (d_model / n_heads)
    full = get_arch(ARCH)
    shapes = TA.init_mla(None, full, device="meta")
    assert full.d_head == 56 and all(56 not in t.shape for t in shapes.values())


@pytest.mark.parametrize("attn_impl", ["kernel", "full", "blocked"])
def test_mla_matches_jax(mla_pair, attn_impl):
    jcfg, cfg, tree, tp = mla_pair
    x = randn(1, B, S, cfg.d_model, scale=0.5)
    for causal in (True, False):
        want = JA.mla(tree, jnp.asarray(x), jcfg, jax_run(), causal=causal)
        run = torch_run(attn_impl).with_(attn_block_q=4, attn_block_kv=4)
        got = TA.mla(tp, torch.from_numpy(x), cfg, run, causal=causal)
        np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)


def test_mla_prefill_emits_the_latent_cache(mla_pair):
    jcfg, cfg, tree, tp = mla_pair
    x = randn(2, B, S, cfg.d_model, scale=0.5)
    want, (wckv, wkr) = JA.mla_prefill(tree, jnp.asarray(x), jcfg, jax_run(),
                                       pad_to=16)
    got, (ckv, kr) = TA.mla_prefill(tp, torch.from_numpy(x), cfg,
                                    torch_run(), pad_to=16)
    m = cfg.mla
    assert tuple(ckv.shape) == (B, 16, m.kv_lora_rank)
    assert tuple(kr.shape) == (B, 16, m.qk_rope_dim)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    np.testing.assert_allclose(as_f32(ckv), as_f32(wckv), **MODEL)
    np.testing.assert_allclose(as_f32(kr), as_f32(wkr), **MODEL)
    assert float(ckv[:, S:].abs().max()) == 0.0 == float(kr[:, S:].abs().max())


def test_mla_decode_matches_jax_and_updates_the_cache_in_place(mla_pair):
    jcfg, cfg, tree, tp = mla_pair
    xs = randn(3, B, S, cfg.d_model, scale=0.3)
    jc = JA.init_mla_cache(jcfg, B, S, jnp.float32)
    tc = TA.init_mla_cache(cfg, B, S, torch.float32)
    ckv, kr = tc["ckv"], tc["kr"]
    for t in range(S):
        want, jc = JA.mla_decode(tree, jnp.asarray(xs[:, t:t + 1]), jc, jcfg,
                                 jax_run())
        got, tc = TA.mla_decode(tp, torch.from_numpy(xs[:, t:t + 1]), tc, cfg,
                                torch_run())
        assert tc["ckv"] is ckv and tc["kr"] is kr
        np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
        for name in ("ckv", "kr"):
            np.testing.assert_allclose(as_f32(tc[name]), as_f32(jc[name]),
                                       **MODEL)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].dtype == torch.int32


def test_mla_absorbed_decode_matches_expanded(mla_pair):
    """The torch analogue of the reference's test of the same name: the
    absorbed-latent decode, token by token, against the expanded full
    sequence, at its tolerances (atol 1e-4, rtol 1e-3)."""
    _, cfg, _, tp = mla_pair
    x = torch.from_numpy(randn(4, B, 8, cfg.d_model, scale=0.3))
    want = TA.mla(tp, x, cfg, torch_run(), causal=True)
    cache = TA.init_mla_cache(cfg, B, 8, torch.float32)
    outs = []
    for t in range(8):
        o, cache = TA.mla_decode(tp, x[:, t:t + 1], cache, cfg, torch_run())
        outs.append(o[:, 0])
    np.testing.assert_allclose(as_f32(torch.stack(outs, 1)), as_f32(want),
                               atol=1e-4, rtol=1e-3)


def test_mla_decode_drops_a_write_past_the_end(mla_pair):
    """A row whose pos is at or past the cache's end writes nothing, as the
    reference's out-of-range scatter (the engine steps idle slots too)."""
    _, cfg, _, tp = mla_pair
    cache = TA.init_mla_cache(cfg, B, 4, torch.float32)
    cache["ckv"].normal_(generator=torch.Generator().manual_seed(0))
    before = cache["ckv"].clone()
    cache["pos"][:] = torch.tensor([4, 2], dtype=torch.int32)
    out, cache = TA.mla_decode(tp, torch.from_numpy(randn(5, B, 1, cfg.d_model)),
                               cache, cfg, torch_run())
    assert bool(torch.isfinite(out).all())
    assert torch.equal(cache["ckv"][0], before[0])
    assert not torch.equal(cache["ckv"][1, 2], before[1, 2])
    assert cache["pos"].tolist() == [5, 3]
