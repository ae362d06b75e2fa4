"""Mamba2 and the Zamba2 hybrid (zamba2-7b) in the port against the JAX
package, float32 on the CPU, on the same numpy inputs and on weights carried
across: the ssd wrapper (its plain version here) against the Pallas kernel
in interpret mode, flash attention at zamba2's head dim 112, the modules of
models/ssm.py, and the whole model, prefill, decode and engine. Tolerances
are the reference's own (tests/test_kernels.py, tests/test_models.py)."""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops
from repro.models import analytic_param_count as jax_param_count
from repro.models import ssm as JS
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import RunConfig, get_arch
from repro_torch.convert import caches_from_numpy, caches_to_numpy
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd import ssd, ssd_plain
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, analytic_param_count, build_model
from repro_torch.models import ssm as TS
from repro_torch.serve.engine import Request, ServeEngine, _reset_slot
from test_torch_parity import (as_f32, layer_of, model_pair, numpy_tree,
                               to_jax, to_torch, torch_run)

ARCH = "zamba2-7b"
B, S, MAX_LEN = 2, 10, 16
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
MODEL = dict(atol=1e-4, rtol=1e-4)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def ssd_inputs(B, S, H, P, N, seed=0):
    xs = randn(seed, B, S, H, P)
    dt = np.log1p(np.exp(randn(seed + 1, B, S, H)))          # softplus
    A = -np.exp(randn(seed + 2, H))
    Bm, Cm = randn(seed + 3, B, S, H, N), randn(seed + 4, B, S, H, N)
    return xs, dt, A, Bm, Cm


def tokens_for(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(batch, seq))


# ---------------------------------------------------------------------------
# the kernels' contracts: ssd vs ops.ssd; flash attention at D = 112
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 32, 2, 16, 8, 16),
    (2, 50, 3, 8, 16, 16),    # padding path
    (1, 16, 1, 32, 4, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_matches_pallas(B, S, H, P, N, chunk, dtype):
    xs, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, N)
    want, none = ops.ssd(to_jax(xs, dtype), jnp.asarray(dt), jnp.asarray(A),
                         to_jax(Bm, dtype), to_jax(Cm, dtype), chunk=chunk)
    got, nothing = ssd(to_torch(xs, dtype), to_torch(dt), to_torch(A),
                       to_torch(Bm, dtype), to_torch(Cm, dtype), chunk=chunk)
    assert none is None and nothing is None
    assert got.dtype == torch.float32
    np.testing.assert_allclose(as_f32(got), as_f32(want),
                               **(F32 if dtype == "float32" else BF16))


def test_ssd_takes_one_group_as_an_expanded_view():
    """Bm / Cm of one group, expand()ed over the heads (zero head stride),
    give what the repeated tensors give, here and in the reference."""
    xs, dt, A, _, _ = ssd_inputs(2, 40, 4, 8, 16, seed=5)
    bg, cg = randn(8, 2, 40, 1, 16), randn(9, 2, 40, 1, 16)
    Bx, Cx = to_torch(bg).expand(2, 40, 4, 16), to_torch(cg).expand(2, 40, 4, 16)
    assert Bx.stride(2) == 0
    got, _ = ssd(to_torch(xs), to_torch(dt), to_torch(A), Bx, Cx, chunk=16)
    rep, _ = ssd(to_torch(xs), to_torch(dt), to_torch(A),
                 Bx.contiguous(), Cx.contiguous(), chunk=16)
    assert torch.equal(got, rep)
    want, _ = ops.ssd(jnp.asarray(xs), jnp.asarray(dt), jnp.asarray(A),
                      jnp.repeat(jnp.asarray(bg), 4, axis=2),
                      jnp.repeat(jnp.asarray(cg), 4, axis=2), chunk=16)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **F32)


def test_ssd_chunked_matches_recurrent():
    xs, dt, A, Bm, Cm = (to_torch(a) for a in ssd_inputs(2, 37, 3, 8, 4, 20))
    h0 = to_torch(randn(25, 2, 3, 4, 8))
    y_r, h_r = TS.ssd_recurrent(xs, dt, A, Bm, Cm, h0=h0)
    for chunk in (8, 16, 37):
        y_c, h_c = TS.ssd_chunked(xs, dt, A, Bm, Cm, chunk=chunk, h0=h0)
        np.testing.assert_allclose(as_f32(y_c), as_f32(y_r), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(as_f32(h_c), as_f32(h_r), atol=1e-4,
                                   rtol=1e-4)
    want, wh = JS.ssd_recurrent(*(jnp.asarray(a.numpy())
                                  for a in (xs, dt, A, Bm, Cm)),
                                h0=jnp.asarray(h0.numpy()))
    np.testing.assert_allclose(as_f32(y_r), as_f32(want), **F32)
    np.testing.assert_allclose(as_f32(h_r), as_f32(wh), **F32)


def test_ssd_wrapper_contract():
    xs, dt, A, Bm, Cm = (to_torch(a) for a in ssd_inputs(1, 9, 2, 8, 4))
    before = ssd.launches
    got, _ = ssd(xs, dt, A, Bm, Cm, chunk=4)
    assert torch.equal(got, ssd_plain(xs, dt, A, Bm, Cm, chunk=4)[0])
    assert ssd.launches == before                   # the CPU launches nothing
    with pytest.raises(ValueError):
        ssd(xs, dt[:, :4], A, Bm, Cm)
    with pytest.raises(ValueError):
        ssd(xs, dt, A[:1], Bm, Cm)
    with pytest.raises(ValueError):
        ssd(xs, dt, A, Bm, Cm[..., :2])
    with pytest.raises(ValueError):
        ssd(xs, dt, A, Bm.bfloat16(), Cm)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_head_dim_112(causal, dtype):
    """zamba2-7b's shared block: d_model 3584 over 32 heads."""
    q, k, v = (randn(60 + i, 1, 40, 2, 112) for i in range(3))
    want = ops.flash_attention(to_jax(q, dtype), to_jax(k, dtype),
                               to_jax(v, dtype), causal=causal, block_q=16,
                               block_kv=16)
    got = flash_attention_plain(to_torch(q, dtype), to_torch(k, dtype),
                                to_torch(v, dtype), causal=causal)
    np.testing.assert_allclose(as_f32(got), as_f32(want),
                               **(F32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# modules, on weights carried across
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) of reduced zamba2-7b, the
    kernel switch on in both packages."""
    return model_pair(jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced())


@pytest.fixture(scope="module")
def layer(pair):
    _, jp, _ = pair
    return layer_of(jp["layers"]["mamba"], 0, 1)


def test_causal_conv(layer):
    jl, tl = layer
    x = randn(30, B, 9, tl["conv_w"].shape[1])
    want = JS._causal_conv(jnp.asarray(x), jl["conv_w"], jl["conv_b"] + 0.1)
    got = TS._causal_conv(to_torch(x), tl["conv_w"], tl["conv_b"] + 0.1)
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-6,
                               rtol=1e-6)


def test_mamba2(pair, layer):
    jm, _, tm = pair
    jl, tl = layer
    x = randn(31, B, 13, tm.cfg.d_model)
    want = JS.mamba2(jl, jnp.asarray(x), jm.cfg, jm.run)
    got = TS.mamba2(tl, to_torch(x), tm.cfg, tm.run)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    full = TS.mamba2(tl, to_torch(x), tm.cfg, torch_run("full"))
    np.testing.assert_allclose(as_f32(full), as_f32(got), **MODEL)


def test_mamba2_decode_updates_the_cache_in_place(pair, layer):
    jm, _, tm = pair
    jl, tl = layer
    cfg = tm.cfg
    jc = JS.init_mamba2_cache(jm.cfg, B, jnp.float32)
    tc = TS.init_mamba2_cache(cfg, B, torch.float32)
    h, conv = tc["h"], tc["conv"]
    xs = randn(40, B, 5, cfg.d_model)
    steps = []
    for t in range(5):
        x = xs[:, t:t + 1]
        want, jc = JS.mamba2_decode(jl, jnp.asarray(x), jc, jm.cfg, jm.run)
        got, back = TS.mamba2_decode(tl, to_torch(x), tc, cfg, tm.run)
        assert back is tc and tc["h"] is h and tc["conv"] is conv
        steps.append(got)
        np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(as_f32(tc[name]), as_f32(jc[name]),
                                       **MODEL)
    # five steps are the full-sequence block
    seq = TS.mamba2(tl, to_torch(xs), cfg, tm.run)
    assert float((torch.cat(steps, 1) - seq).abs().max()) < 5e-4


# ---------------------------------------------------------------------------
# the slice: Model, prefill, decode, caches, engine, CLI
# ---------------------------------------------------------------------------


def test_config_is_the_references():
    assert asdict(get_arch(ARCH)) == asdict(jax_get_arch(ARCH))
    assert get_arch(ARCH).d_head == 112


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
    n = 6
    toks = tokens_for(tm.cfg, seed=3, seq=n)
    full = tm.forward({"tokens": toks})
    caches = tm.init_caches(B, n)
    jcaches = jm.init_caches(B, n)
    steps = []
    for t in range(n):
        lg, caches = tm.decode_step({"tokens": toks[:, t:t + 1]}, caches)
        jlg, jcaches = jm.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcaches)
        steps.append(lg[:, 0])
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    err = float((full - torch.stack(steps, 1)).abs().max())
    assert err < 5e-4, f"decode mismatch {err}"
    for group in ("mamba", "attn"):
        for name, leaf in caches[group].items():
            np.testing.assert_allclose(as_f32(leaf),
                                       as_f32(jcaches[group][name]), **MODEL)


def test_prefill_returns_last_logits_and_zeroed_caches(pair):
    """As the reference: forward, then freshly zeroed caches."""
    jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=2)
    want, wc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    got, gc = tm.prefill({"tokens": toks}, MAX_LEN)
    assert tuple(got.shape) == (B, 1, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    assert sorted(gc) == sorted(wc) == ["attn", "mamba"]
    for group in wc:
        assert sorted(gc[group]) == sorted(wc[group])
        for name, leaf in wc[group].items():
            assert tuple(gc[group][name].shape) == tuple(leaf.shape)
            assert float(gc[group][name].abs().max()) == 0.0
    assert gc["mamba"]["h"].dtype == torch.float32
    assert gc["attn"]["pos"].dtype == torch.int32


def test_caches_round_trip(pair):
    jm, jp, tm = pair
    toks = tokens_for(tm.cfg, seed=6)
    jc = jm.init_caches(B, MAX_LEN)
    for t in range(2):
        _, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               jc)
    tc = caches_from_numpy(numpy_tree(jc), tm)
    nxt = toks[:, 2:3]
    lg, tc = tm.decode_step({"tokens": nxt}, tc)
    jlg, jc2 = jm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    back = caches_to_numpy(tc)
    assert sorted(back["mamba"]) == ["conv", "h"]
    assert sorted(back["attn"]) == ["k", "pos", "v"]
    for group in back:
        for name, leaf in back[group].items():
            np.testing.assert_allclose(leaf, np.asarray(jc2[group][name]),
                                       **MODEL)
    bad = {"mamba": {**back["mamba"], "h": back["mamba"]["h"][..., :-1]},
           "attn": back["attn"]}
    with pytest.raises(ValueError, match="mamba.h"):
        caches_from_numpy(bad, tm)
    with pytest.raises(KeyError):
        caches_from_numpy({"mamba": back["mamba"]}, tm)


def test_param_count_equals_jax():
    for jcfg, cfg in ((jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()),
                      (jax_get_arch(ARCH), get_arch(ARCH))):
        assert analytic_param_count(cfg) == jax_param_count(jcfg)
    assert get_arch(ARCH).param_count() == 6_722_724_704


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
    in_proj = sa["layers.mamba.in_proj"]
    assert tuple(in_proj.shape[:2]) == (2, cfg.hybrid.period)
    assert not torch.equal(in_proj[0, 0], in_proj[0, 1])
    assert not torch.equal(sa["layers.shared.attn.wq"][0],
                           sa["layers.shared.attn.wq"][1])
    # A = -exp(A_log) from 1 to 16 over the heads; dt_bias in softplus^-1 of
    # [1e-3, 1e-1]
    assert float(sa["layers.mamba.A_log"].float().max()) == \
        pytest.approx(np.log(16.0), abs=2e-2)
    dt = torch.nn.functional.softplus(sa["layers.mamba.dt_bias"].float())
    assert 9e-4 <= float(dt.min()) and float(dt.max()) <= 0.11
    out = a.forward({"tokens": tokens_for(cfg)})
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


def test_same_greedy_tokens_as_the_jax_engine():
    jm, jp, tm = model_pair(jax_get_arch(ARCH).reduced(),
                            get_arch(ARCH).reduced(), jax_attn="full")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tm.cfg.vocab_size, size=n).tolist()
               for n in (3, 5, 2)]
    jeng = JServeEngine(jm, jp, slots=2, max_len=32)
    teng = ServeEngine(tm, slots=2, max_len=32)
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid, prompt=list(prompt), max_new_tokens=5))
        teng.submit(Request(rid, prompt=list(prompt), max_new_tokens=5))
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want


def test_admitted_slot_starts_from_zeroed_state(pair):
    """_reset_slot walks the nested {"mamba", "attn"} tree: one slot's
    Mamba2 state, conv window, KV and pos are cleared in place, the other
    slots keep theirs; a request in a recycled slot then gets the tokens it
    gets on a fresh engine."""
    _, _, tm = pair
    caches = tm.init_caches(3, 8)
    for group in caches.values():
        for leaf in group.values():
            leaf.fill_(1)
    assert _reset_slot(caches, 1) is caches
    for group, batch_axis in (("mamba", 2), ("attn", 1)):
        for name, leaf in caches[group].items():
            assert float(leaf.select(batch_axis, 1).abs().sum()) == 0.0, name
            assert bool((leaf.select(batch_axis, 0) == 1).all()), name
            assert bool((leaf.select(batch_axis, 2) == 1).all()), name

    eng = ServeEngine(tm, slots=2, max_len=32)
    eng.submit(Request(0, prompt=[9, 8, 7], max_new_tokens=4))
    eng.submit(Request(1, prompt=[4, 5, 6, 7, 8, 9], max_new_tokens=3))
    eng.submit(Request(2, prompt=[3, 2, 1], max_new_tokens=4))
    done = {r.rid: r.out_tokens for r in eng.run()}
    fresh = ServeEngine(tm, slots=1, max_len=32)
    fresh.submit(Request(2, prompt=[3, 2, 1], max_new_tokens=4))
    assert done[2] == fresh.run()[0].out_tokens


def test_launcher_runs_reduced_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--dtype", "float32", "--requests", "3",
                              "--slots", "2", "--max-new", "3",
                              "--prompt-len", "4", "--max-len", "16"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert f"[serve] {ARCH}: 3 requests, 9 tokens" in capsys.readouterr().out
