"""GQA attention of the port against repro.models.attention on the same
numpy inputs and weights, float32 at 2e-5. The JAX side runs with attn_impl
"full" and "pallas" (the Pallas body in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import attention as JA

from repro_torch.configs import RunConfig, get_arch
from repro_torch.models import attention as TA
from test_torch_parity import as_f32, jax_run, to_jax, to_torch, torch_run

TOL = dict(atol=2e-5, rtol=2e-5)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def qkv(B=2, Sq=7, Sk=7, H=4, K=2, D=16, seed=0):
    return (randn(seed, B, Sq, H, D), randn(seed + 1, B, Sk, K, D),
            randn(seed + 2, B, Sk, K, D))


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention(causal):
    q, k, v = qkv()
    want = JA.full_attention(to_jax(q), to_jax(k), to_jax(v), causal=causal)
    got = TA.full_attention(to_torch(q), to_torch(k), to_torch(v),
                            causal=causal)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


def test_full_attention_q_offset():
    q, k, v = qkv(Sq=3, Sk=10)
    want = JA.full_attention(to_jax(q), to_jax(k), to_jax(v), causal=True,
                             q_offset=7)
    got = TA.full_attention(to_torch(q), to_torch(k), to_torch(v),
                            causal=True, q_offset=7)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


@pytest.mark.parametrize("kv_len", [5, [3, 10]])
def test_full_attention_kv_len(kv_len):
    q, k, v = qkv(Sq=1, Sk=10)
    want = JA.full_attention(to_jax(q), to_jax(k), to_jax(v), causal=False,
                             kv_len=jnp.asarray(kv_len))
    got = TA.full_attention(to_torch(q), to_torch(k), to_torch(v),
                            causal=False, kv_len=torch.tensor(kv_len))
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)
    dec = TA.decode_attention(to_torch(q), to_torch(k), to_torch(v),
                              torch.tensor(kv_len))
    assert torch.equal(dec, got)


# ---------------------------------------------------------------------------
# the GQA module, on weights carried across
# ---------------------------------------------------------------------------

ARCHS = ["deepseek-7b", "chatglm3-6b", "nemotron-4-15b"]


def gqa_setup(arch, B=2, S=12, seed=0):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    w = {"wq": randn(seed, d, H, Dh) / np.sqrt(d),
         "wk": randn(seed + 1, d, K, Dh) / np.sqrt(d),
         "wv": randn(seed + 2, d, K, Dh) / np.sqrt(d),
         "wo": randn(seed + 3, H, Dh, d) / np.sqrt(H * Dh)}
    x = randn(seed + 4, B, S, d)
    return (jcfg, cfg, {n: to_jax(a) for n, a in w.items()},
            {n: to_torch(a) for n, a in w.items()}, x)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("jax_impl,torch_impl", [("full", "full"),
                                                 ("pallas", "kernel"),
                                                 ("full", "kernel")])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa(arch, jax_impl, torch_impl, causal):
    jcfg, cfg, jw, tw, x = gqa_setup(arch)
    want = JA.gqa(jw, to_jax(x), jcfg, jax_run(jax_impl), causal=causal)
    got = TA.gqa(tw, to_torch(x), cfg, torch_run(torch_impl), causal=causal)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("torch_impl", ["full", "kernel"])
@pytest.mark.parametrize("pad_to", [0, 20])
def test_gqa_prefill(arch, torch_impl, pad_to):
    """The port's prefill goes through the kernel's wrapper when asked to;
    the reference's takes its plain path whatever it is told. Both compute
    the same function."""
    jcfg, cfg, jw, tw, x = gqa_setup(arch)
    want, (wk, wv) = JA.gqa_prefill(jw, to_jax(x), jcfg, jax_run("full"),
                                    pad_to=pad_to)
    got, (gk, gv) = TA.gqa_prefill(tw, to_torch(x), cfg,
                                   torch_run(torch_impl), pad_to=pad_to)
    S = x.shape[1]
    assert gk.shape[1] == max(S, pad_to)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)
    np.testing.assert_allclose(as_f32(gk), as_f32(wk), **TOL)
    np.testing.assert_allclose(as_f32(gv), as_f32(wv), **TOL)
    assert float(gk[:, S:].abs().max() if pad_to else 0.0) == 0.0


def decode_setup(arch, pos, smax=8, seed=20):
    B = len(pos)
    jcfg, cfg, jw, tw, x = gqa_setup(arch, B=B, S=1, seed=seed)
    K, Dh = cfg.n_kv_heads, cfg.d_head
    kc, vc = randn(seed + 5, B, smax, K, Dh), randn(seed + 6, B, smax, K, Dh)
    jcache = {"k": to_jax(kc), "v": to_jax(vc),
              "pos": jnp.asarray(pos, jnp.int32)}
    tcache = {"k": to_torch(kc), "v": to_torch(vc),
              "pos": torch.tensor(pos, dtype=torch.int32)}
    return jcfg, cfg, jw, tw, x, jcache, tcache, kc


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_decode_per_row_pos(arch):
    jcfg, cfg, jw, tw, x, jcache, tcache, _ = decode_setup(arch, [0, 5, 7])
    want, wc = JA.gqa_decode(jw, to_jax(x), jcache, jcfg, jax_run("full"))
    got, gc = TA.gqa_decode(tw, to_torch(x), tcache, cfg, torch_run())
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(as_f32(gc[name]), as_f32(wc[name]), **TOL)
    assert gc["pos"].tolist() == np.asarray(wc["pos"]).tolist() == [1, 6, 8]
    assert gc["k"] is tcache["k"]           # updated in place, and said so


def test_gqa_decode_drops_a_write_past_the_end():
    """A row whose pos is at or past Smax leaves the cache untouched, as the
    reference's out-of-range scatter does; the other rows write."""
    jcfg, cfg, jw, tw, x, jcache, tcache, kc = decode_setup(
        "deepseek-7b", [8, 3, 11])
    want, wc = JA.gqa_decode(jw, to_jax(x), jcache, jcfg, jax_run("full"))
    got, gc = TA.gqa_decode(tw, to_torch(x), tcache, cfg, torch_run())
    assert np.array_equal(as_f32(gc["k"][0]), kc[0])
    assert np.array_equal(as_f32(gc["k"][2]), kc[2])
    assert not np.array_equal(as_f32(gc["k"][1, 3]), kc[1, 3])
    for name in ("k", "v"):
        np.testing.assert_allclose(as_f32(gc[name]), as_f32(wc[name]), **TOL)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)
    assert gc["pos"].tolist() == [9, 4, 12]
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("impl", ["blocked", "zigzag"])
def test_unported_attention_paths_raise(impl):
    """The two paths that once raised here are ported: the module runs
    them as the reference does (blocks of 4 on 12 tokens, so zigzag's three
    blocks of queries take the plain schedule, as the reference's would),
    and an attn_impl no package knows still raises."""
    jcfg, cfg, jw, tw, x = gqa_setup("deepseek-7b")
    jrun = jax_run("full").__class__(attn_impl=impl, remat="nothing",
                                     compute_dtype="float32",
                                     attn_block_q=4, attn_block_kv=4)
    want = JA.gqa(jw, to_jax(x), jcfg, jrun)
    got = TA.gqa(tw, to_torch(x), cfg,
                 RunConfig(attn_impl=impl, attn_block_q=4, attn_block_kv=4))
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)
    with pytest.raises(ValueError, match="attn_impl"):
        TA.gqa(tw, to_torch(x), cfg, RunConfig(attn_impl="nonesuch"))


# the reference's blocked walk at several block shapes: ragged edges on
# both sides, Sq != Sk, one block, many, and the zigzag schedule with an
# even number of square blocks (and an odd one, where it takes the plain walk)
BLOCKED_CASES = [
    # B, Sq, Sk, H, K, D, block_q, block_kv, causal, zigzag
    (2, 64, 64, 4, 2, 16, 16, 32, True, False),
    (1, 50, 70, 4, 1, 8, 16, 32, False, False),
    (2, 37, 37, 4, 2, 8, 8, 16, True, False),
    (1, 40, 40, 2, 2, 8, 64, 64, True, False),
    (2, 64, 64, 4, 2, 16, 16, 16, True, True),
    (2, 96, 96, 4, 4, 8, 16, 16, True, True),
    (1, 48, 48, 4, 2, 8, 16, 16, True, True),
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,bq,bkv,causal,zigzag", BLOCKED_CASES)
def test_blocked_attention_matches_the_reference(B, Sq, Sk, H, K, D, bq, bkv,
                                                 causal, zigzag):
    q, k, v = qkv(B, Sq, Sk, H, K, D, seed=30)
    want = JA.blocked_attention(to_jax(q), to_jax(k), to_jax(v),
                                causal=causal, block_q=bq, block_kv=bkv,
                                zigzag=zigzag)
    got = TA.blocked_attention(to_torch(q), to_torch(k), to_torch(v),
                               causal=causal, block_q=bq, block_kv=bkv,
                               zigzag=zigzag)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,bq,bkv,causal,zigzag", BLOCKED_CASES)
def test_blocked_attention_gradients_match_full(B, Sq, Sk, H, K, D, bq, bkv,
                                                causal, zigzag):
    """Under autograd the blocked walk (its running maximum off the graph)
    gives full attention's gradients, for q, k and v."""
    arrays = qkv(B, Sq, Sk, H, K, D, seed=40)
    g = to_torch(randn(41, B, Sq, H, D))
    grads = []
    for fn in (lambda q, k, v: TA.blocked_attention(
                   q, k, v, causal=causal, block_q=bq, block_kv=bkv,
                   zigzag=zigzag),
               lambda q, k, v: TA.full_attention(q, k, v, causal=causal)):
        leaves = [to_torch(a).requires_grad_() for a in arrays]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL)


def test_zigzag_needs_square_blocks():
    q, k, v = qkv(1, 32, 32, 2, 2, 8)
    with pytest.raises(ValueError, match="square"):
        TA.blocked_attention(to_torch(q), to_torch(k), to_torch(v),
                             causal=True, block_q=8, block_kv=16, zigzag=True)


def test_init_gqa_and_cache_shapes():
    cfg = get_arch("chatglm3-6b").reduced()
    p = TA.init_gqa(torch.Generator().manual_seed(0), cfg)
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    assert {n: tuple(a.shape) for n, a in p.items()} == {
        "wq": (d, H, Dh), "wk": (d, K, Dh), "wv": (d, K, Dh),
        "wo": (H, Dh, d)}
    c = TA.init_gqa_cache(cfg, 3, 10, torch.bfloat16)
    assert tuple(c["k"].shape) == (3, 10, K, Dh) and c["k"].dtype == torch.bfloat16
    assert c["pos"].dtype == torch.int32 and tuple(c["pos"].shape) == (3,)
    c = TA.init_gqa_cache(cfg, 3, 10, torch.bfloat16, quant=True)
    assert {n: (tuple(a.shape), a.dtype) for n, a in c.items()} == {
        "k": ((3, 10, K, Dh), torch.int8), "v": ((3, 10, K, Dh), torch.int8),
        "k_scale": ((3, 10, K, 1), torch.bfloat16),
        "v_scale": ((3, 10, K, 1), torch.bfloat16),
        "pos": ((3,), torch.int32)}
