"""RWKV6 (rwkv6-7b) in the port against the JAX package, float32 on the CPU,
on the same numpy inputs and on weights carried across: the wkv6 wrapper
(its plain version here) against the Pallas kernel in interpret mode, the
modules of models/rwkv.py, and the whole model, prefill, decode and engine.
Tolerances are the reference's own (tests/test_kernels.py,
tests/test_models.py)."""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops
from repro.models import analytic_param_count as jax_param_count
from repro.models import rwkv as JR
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import RunConfig, get_arch
from repro_torch.convert import caches_from_numpy, caches_to_numpy
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, analytic_param_count, build_model
from repro_torch.models import rwkv as TR
from repro_torch.serve.engine import Request, ServeEngine, _reset_slot
from test_torch_parity import (as_f32, layer_of, model_pair, numpy_tree,
                               to_jax, to_torch, torch_run)

ARCH = "rwkv6-7b"
B, S, MAX_LEN = 2, 12, 16
# the chunked kernel re-associates the recurrence (tests/test_kernels.py)
WKV_F32 = dict(atol=1e-4, rtol=5e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
STATE = dict(atol=1e-3, rtol=1e-3)
MODEL = dict(atol=1e-4, rtol=1e-4)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def wkv_inputs(B, S, H, K, seed=0):
    r, k, v = (randn(seed + i, B, S, H, K) for i in range(3))
    lw = -np.exp(randn(seed + 3, B, S, H, K))
    u = 0.3 * randn(seed + 4, H, K)
    return r, k, v, lw, u


def tokens_for(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(batch, seq))


# ---------------------------------------------------------------------------
# the kernel's contract: wkv6 wrapper (plain version on the CPU) vs ops.wkv6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,K,chunk", [
    (1, 16, 1, 8, 16),
    (2, 40, 3, 16, 16),
    (1, 33, 2, 32, 8),        # padding path
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_matches_pallas(B, S, H, K, chunk, dtype):
    r, k, v, lw, u = wkv_inputs(B, S, H, K)
    want, wst = ops.wkv6(to_jax(r, dtype), to_jax(k, dtype), to_jax(v, dtype),
                         jnp.asarray(lw), jnp.asarray(u), chunk=chunk)
    got, gst = wkv6(to_torch(r, dtype), to_torch(k, dtype), to_torch(v, dtype),
                    to_torch(lw), to_torch(u), chunk=chunk)
    assert got.dtype == gst.dtype == torch.float32
    assert tuple(gst.shape) == (B, H, K, K)
    tol = WKV_F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(as_f32(got), as_f32(want), **tol)
    np.testing.assert_allclose(as_f32(gst), as_f32(wst), **STATE)


@pytest.mark.parametrize("S", [24, 1])
def test_wkv6_with_incoming_state(S):
    """S=24 as the reference's test; S=1 is every decode step."""
    r, k, v, lw, u = wkv_inputs(3, S, 2, 8, seed=10)
    st0 = randn(15, 3, 2, 8, 8)
    want, wst = ops.wkv6(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                         state=jnp.asarray(st0))
    got, gst = wkv6(*(to_torch(a) for a in (r, k, v, lw, u)),
                    state=to_torch(st0))
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(as_f32(gst), as_f32(wst), atol=1e-4, rtol=1e-4)
    # the decode path's in-place form: the state tensor itself is updated
    state = to_torch(st0)
    y2, out = wkv6(*(to_torch(a) for a in (r, k, v, lw, u)), state=state,
                   state_out=state)
    assert out is state
    assert torch.equal(y2, got) and torch.equal(state, gst)


def test_wkv_chunked_matches_recurrent():
    r, k, v, lw, u = (to_torch(a) for a in wkv_inputs(2, 37, 2, 16, seed=20))
    st0 = to_torch(randn(25, 2, 2, 16, 16))
    for chunk in (16, 8, 37):
        y_c, s_c = TR.wkv_chunked(r, k, v, lw, u, chunk=chunk, state=st0)
        y_r, s_r = TR.wkv_recurrent(r, k, v, lw, u, state=st0)
        np.testing.assert_allclose(as_f32(y_c), as_f32(y_r), **WKV_F32)
        np.testing.assert_allclose(as_f32(s_c), as_f32(s_r), **STATE)
    # and the port's recurrent oracle is the reference's
    want, wst = JR.wkv_recurrent(*(jnp.asarray(a.numpy())
                                   for a in (r, k, v, lw, u)),
                                 state=jnp.asarray(st0.numpy()))
    np.testing.assert_allclose(as_f32(y_r), as_f32(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(as_f32(s_r), as_f32(wst), atol=1e-5, rtol=1e-5)


def _hi_lo(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def wkv_kernel_rounding(r, k, v, lw, u, state=None, chunk=16):
    """The bf16 wkv6 kernel's rounding in plain PyTorch: each chunk's A
    exact in float32, r~ = r exp(cum_prev), k~ = k exp(cum[last] - cum)
    and the state each split into a high and a low bfloat16 half, r~ S as
    hi hi + hi lo + lo hi and k~^T V as (hi + lo) V with float32 sums, the
    state's master in float32."""
    B, S, H, K = r.shape
    r, k, v, lw = (a.float() for a in (r, k, v, lw))
    st = torch.zeros((B, H, K, K)) if state is None else state.clone()
    ys = []
    for c0 in range(0, S, chunk):
        rq, kq, vq, wq = (a[:, c0:c0 + chunk] for a in (r, k, v, lw))
        cum = torch.cumsum(wq, dim=1)
        cum_prev = cum - wq
        q = rq.shape[1]
        expo = cum_prev[:, :, None] - cum[:, None, :]
        tri = torch.tril(torch.ones(q, q), -1)
        a = torch.einsum("bthk,bjhk,btjhk->bhtj", rq, kq,
                         torch.exp(torch.clamp(expo, max=0.0))) * tri
        diag = torch.einsum("bthk,hk,bthk->bth", rq, u, kq)
        y = torch.einsum("bhtj,bjhk->bthk", a, vq) + diag[..., None] * vq
        r_hi, r_lo = _hi_lo(rq * torch.exp(cum_prev))
        s_hi, s_lo = _hi_lo(st)
        y = y + sum(torch.einsum("bthk,bhkv->bthv", x, s)
                    for x, s in ((r_hi, s_hi), (r_hi, s_lo), (r_lo, s_hi)))
        k_hi, k_lo = _hi_lo(kq * torch.exp(cum[:, -1:] - cum))
        st = st * torch.exp(cum[:, -1])[..., None] + \
            torch.einsum("bjhk,bjhv->bhkv", k_hi, vq) + \
            torch.einsum("bjhk,bjhv->bhkv", k_lo, vq)
        ys.append(y)
    return torch.cat(ys, dim=1), st


def test_bf16_kernel_rounding_keeps_2048_rows_within_bf16_tolerance():
    """The precision budget of the bf16 kernel's hi/lo products, on the CPU:
    over 2048 rows (128 chunks) with rwkv6-7b's decay and an incoming
    state, its rounding stays within bf16's tolerance of the plain version
    on the same bf16 inputs, and far inside it."""
    B, S, H, K = 1, 2048, 2, 64
    rng = np.random.default_rng(40)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, K),
                                                    dtype=np.float32))
               .bfloat16() for _ in range(3))
    lw = -torch.exp(torch.from_numpy(
        -0.6 + 0.5 * rng.standard_normal((B, S, H, K), dtype=np.float32)))
    u = torch.from_numpy(0.1 * rng.standard_normal((H, K), dtype=np.float32))
    st0 = torch.from_numpy(rng.standard_normal((B, H, K, K), dtype=np.float32))
    y, st = wkv_kernel_rounding(r, k, v, lw, u, state=st0)
    want, want_st = wkv6_plain(r, k, v, lw, u, state=st0)
    np.testing.assert_allclose(as_f32(y), as_f32(want), **BF16)
    np.testing.assert_allclose(as_f32(st), as_f32(want_st), **STATE)
    assert float((y - want).abs().max()) < 1e-3


def test_wkv6_wrapper_contract():
    r, k, v, lw, u = (to_torch(a) for a in wkv_inputs(1, 5, 2, 8))
    before = wkv6.launches
    y, st = wkv6(r, k, v, lw, u)
    want_y, want_st = wkv6_plain(r, k, v, lw, u)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert wkv6.launches == before                  # the CPU launches nothing
    with pytest.raises(ValueError):
        wkv6(r, k, v[:, :4], lw, u)
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw, u[:1])
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw, u, state=torch.zeros((1, 2, 8, 4)))
    with pytest.raises(ValueError):
        wkv6(r, k.bfloat16(), v, lw, u)


# ---------------------------------------------------------------------------
# modules, on weights carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) of reduced rwkv6-7b, the kernel
    switch on in both packages."""
    return model_pair(jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced())


@pytest.fixture(scope="module")
def layer(pair):
    jm, jp, tm = pair
    return layer_of(jp["layers"], 0)


@pytest.mark.parametrize("carried", [False, True])
def test_time_mix(pair, layer, carried):
    jm, _, tm = pair
    jl, tl = layer
    cfg, d = tm.cfg, tm.cfg.d_model
    H, K = cfg.n_heads, d // cfg.n_heads
    x = randn(30, B, 7, d)
    state = 0.5 * randn(31, B, H, K, K) if carried else None
    last = randn(32, B, d) if carried else None
    jkw = dict(state=jnp.asarray(state), shift_last=jnp.asarray(last)) \
        if carried else {}
    tkw = dict(state=to_torch(state), shift_last=to_torch(last)) \
        if carried else {}
    want, (wst, wlast) = JR.time_mix(jl, jnp.asarray(x), jm.cfg, jm.run, **jkw)
    got, (gst, glast) = TR.time_mix(tl, to_torch(x), cfg, tm.run, **tkw)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    np.testing.assert_allclose(as_f32(gst), as_f32(wst), **STATE)
    assert np.array_equal(as_f32(glast), as_f32(wlast))


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix(layer, carried):
    jl, tl = layer
    d = tl["cm_r"].shape[0]
    x = randn(33, B, 5, d)
    last = randn(34, B, d) if carried else None
    want, wlast = JR.channel_mix(
        jl, jnp.asarray(x), jnp.asarray(last) if carried else None)
    got, glast = TR.channel_mix(tl, to_torch(x),
                                to_torch(last) if carried else None)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-5,
                               rtol=1e-5)
    assert np.array_equal(as_f32(glast), as_f32(wlast))


def test_rwkv_block_decode_updates_the_cache_in_place(pair, layer):
    jm, _, tm = pair
    jl, tl = layer
    cfg = tm.cfg
    norms_j = {"ln1": jl["ln1"], "ln2": jl["ln2"]}
    norms_t = {"ln1": tl["ln1"], "ln2": tl["ln2"]}
    jc = JR.init_rwkv_cache(jm.cfg, B, jnp.float32)
    tc = TR.init_rwkv_cache(cfg, B, torch.float32)
    wkv = tc["wkv"]
    for t in range(3):
        x = randn(40 + t, B, 1, cfg.d_model)
        want, jc = JR.rwkv_block_decode(jl, jnp.asarray(x), jc, jm.cfg,
                                        jm.run, norms_j)
        got, back = TR.rwkv_block_decode(tl, to_torch(x), tc, cfg, tm.run,
                                         norms_t)
        assert back is tc and tc["wkv"] is wkv
        np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
        for name in ("wkv", "tm_last", "cm_last"):
            np.testing.assert_allclose(as_f32(tc[name]), as_f32(jc[name]),
                                       **MODEL)


# ---------------------------------------------------------------------------
# the slice: Model, prefill, decode, caches, engine, CLI
# ---------------------------------------------------------------------------


def test_config_is_the_references():
    assert asdict(get_arch(ARCH)) == asdict(jax_get_arch(ARCH))


def test_forward_matches_jax_with_the_kernel_switch_on(pair):
    jm, jp, tm = pair
    assert jm.run.attn_impl == "pallas" and tm.run.attn_impl == "kernel"
    toks = tokens_for(tm.cfg)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = tm.forward({"tokens": toks})
    assert tuple(got.shape) == (B, S, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)


def test_forward_kernel_and_full_paths_agree(pair):
    _, _, tm = pair
    full = Model(tm.cfg, torch_run("full"), device="cpu")
    full.load_state_dict(tm.state_dict())
    toks = tokens_for(tm.cfg, seed=1)
    np.testing.assert_allclose(as_f32(full.forward({"tokens": toks})),
                               as_f32(tm.forward({"tokens": toks})), **MODEL)


def test_decode_matches_own_forward_and_jax(pair):
    jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=3, seq=8)
    full = tm.forward({"tokens": toks})
    caches = tm.init_caches(B, 8)
    jcaches = jm.init_caches(B, 8)
    steps = []
    for t in range(8):
        lg, caches = tm.decode_step({"tokens": toks[:, t:t + 1]}, caches)
        jlg, jcaches = jm.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcaches)
        steps.append(lg[:, 0])
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    err = float((full - torch.stack(steps, 1)).abs().max())
    assert err < 5e-4, f"decode mismatch {err}"
    for name in ("wkv", "tm_last", "cm_last"):
        np.testing.assert_allclose(as_f32(caches[name]),
                                   as_f32(jcaches[name]), **STATE)


def test_prefill_returns_last_logits_and_zeroed_caches(pair):
    """As the reference: forward, then freshly zeroed caches."""
    jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=2)
    want, wc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, gc = tm.prefill({"tokens": toks}, MAX_LEN)
    assert tuple(got.shape) == (B, 1, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    np.testing.assert_allclose(as_f32(got[:, 0]),
                               as_f32(tm.forward({"tokens": toks})[:, -1]),
                               atol=1e-5, rtol=1e-5)
    assert sorted(gc) == sorted(wc)
    for name in wc:
        assert tuple(gc[name].shape) == tuple(wc[name].shape)
        assert float(gc[name].abs().max()) == 0.0
    assert gc["wkv"].dtype == torch.float32


def test_caches_round_trip(pair):
    jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=6)
    jc = jm.init_caches(B, MAX_LEN)
    for t in range(3):
        _, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               jc)
    tc = caches_from_numpy(numpy_tree(jc), tm)
    assert tc["wkv"].dtype == torch.float32
    nxt = toks[:, 3:4]
    lg, tc = tm.decode_step({"tokens": nxt}, tc)
    jlg, jc2 = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    back = caches_to_numpy(tc)
    assert sorted(back) == ["cm_last", "tm_last", "wkv"]
    for name in back:
        np.testing.assert_allclose(back[name], np.asarray(jc2[name]), **STATE)
    with pytest.raises(ValueError, match="wkv"):
        caches_from_numpy({**back, "wkv": back["wkv"][..., :-1]}, tm)
    with pytest.raises(KeyError):
        caches_from_numpy({"wkv": back["wkv"], "tm_last": back["tm_last"]},
                          tm)
    with pytest.raises(KeyError):
        caches_from_numpy({**back, "k": back["wkv"]}, tm)


def test_param_count_equals_jax():
    for jcfg, cfg in ((jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()),
                      (jax_get_arch(ARCH), get_arch(ARCH))):
        assert analytic_param_count(cfg) == jax_param_count(jcfg)
    assert get_arch(ARCH).param_count() == 7_534_546_944


def test_state_dict_keys_are_the_jax_tree_paths(pair):
    _, jp, tm = pair
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    paths = {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == paths


def test_init_is_seeded_and_in_param_dtype():
    cfg = get_arch(ARCH).reduced()
    run = RunConfig(param_dtype="bfloat16", compute_dtype="bfloat16")
    a = build_model(cfg, run, device="cpu", seed=3)
    b = build_model(cfg, run, device="cpu", seed=3)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(v.dtype == torch.bfloat16 for v in sa.values())
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert float(sa["layers.w0"].float().max()) == pytest.approx(-0.6, abs=4e-3)
    assert not torch.equal(sa["layers.wr"][0], sa["layers.wr"][1])
    out = a.forward({"tokens": tokens_for(cfg)})
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


def test_same_greedy_tokens_as_the_jax_engine():
    jm, jp, tm = model_pair(jax_get_arch(ARCH).reduced(),
                            get_arch(ARCH).reduced(), jax_attn="full")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tm.cfg.vocab_size, size=n).tolist()
               for n in (3, 5, 2, 4, 3)]
    jeng = JServeEngine(jm, jp, slots=2, max_len=32)
    teng = ServeEngine(tm, slots=2, max_len=32)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid, prompt=list(prompt), max_new_tokens=6))
        teng.submit(Request(rid, prompt=list(prompt), max_new_tokens=6))
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want


def test_admitted_slot_starts_from_zeroed_state(pair):
    """_reset_slot clears one slot's recurrent state in place and leaves
    the other slots' alone; a request in a recycled slot then gets the
    tokens it gets on a fresh engine."""
    _, _, tm = pair
    caches = tm.init_caches(3, 8)
    for leaf in caches.values():
        leaf.fill_(1)
    assert _reset_slot(caches, 1) is caches
    for name, leaf in caches.items():
        assert float(leaf[:, 1].abs().sum()) == 0.0, name
        assert bool((leaf[:, 0] == 1).all() and (leaf[:, 2] == 1).all()), name

    eng = ServeEngine(tm, slots=2, max_len=32)
    eng.submit(Request(0, prompt=[9, 8, 7], max_new_tokens=5))
    eng.submit(Request(1, prompt=[4, 5, 6, 7, 8, 9, 10], max_new_tokens=3))
    eng.submit(Request(2, prompt=[3, 2, 1], max_new_tokens=5))
    done = {r.rid: r.out_tokens for r in eng.run()}
    fresh = ServeEngine(tm, slots=1, max_len=32)
    fresh.submit(Request(2, prompt=[3, 2, 1], max_new_tokens=5))
    assert done[2] == fresh.run()[0].out_tokens


def test_launcher_runs_reduced_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--dtype", "float32", "--requests", "3",
                              "--slots", "2", "--max-new", "3",
                              "--prompt-len", "4", "--max-len", "16"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert f"[serve] {ARCH}: 3 requests, 9 tokens" in capsys.readouterr().out
