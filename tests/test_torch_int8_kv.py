"""The int8 KV cache of the port against the JAX package, on the CPU, on the
same numpy inputs and on weights carried across: ``quantize_kv`` bit for
bit, ``decode_attention_q8`` to 2e-5 in float32, the int8 branch of
``gqa_decode`` (with the write dropped past the cache's end), the decode of
every family that keeps a GQA cache, the prefill that hands back
unquantized caches (as the reference's does), the caches' conversion both
ways, the reference's own accuracy gate (decode within 5 % of forward) and
``launch.serve --int8-kv``.

An int8 cache entry may sit one quantisation step off the reference's,
where the float32 k or v the two packages compute differ in their last bit
at a rounding boundary; the scales then differ by at most one bfloat16
step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import attention as JA
from repro.models import build_model as jax_build_model

from repro_torch.configs import RunConfig, get_arch
from repro_torch.convert import (caches_from_numpy, caches_to_numpy,
                                 params_from_numpy)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model
from repro_torch.models import attention as TA
from test_torch_parity import as_f32, jax_run, numpy_tree

B, S = 2, 10
F32 = dict(atol=2e-5, rtol=2e-5)
LOGITS = dict(atol=1e-3, rtol=1e-3)
# one bfloat16 step: 2^-7 of the value
SCALE_RTOL = 2 ** -7


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def tokens_for(cfg, seed=0, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(B, seq))


def int8_pair(arch, seed=0):
    """(jax model, jax params, torch model on the CPU) of the reduced
    `arch` with an int8 KV cache in both packages, on the reference's
    weights; the vlm's tanh gates set nonzero (they start at 0, which
    would hide the cross path)."""
    jm = jax_build_model(jax_get_arch(arch).reduced(),
                         jax_run().with_(kv_cache_dtype="int8"))
    jp = jm.init(jax.random.PRNGKey(seed))
    if jm.cfg.family == "vlm":
        n = np.asarray(jp["layers"]["cross"]["attn"]["gate"]).shape
        jp["layers"]["cross"]["attn"]["gate"] = jnp.full(n, 0.5, jnp.float32)
    run = RunConfig(attn_impl="kernel", remat="nothing",
                    compute_dtype="float32", kv_cache_dtype="int8")
    tm = params_from_numpy(numpy_tree(jp),
                           Model(get_arch(arch).reduced(), run, device="cpu"))
    return jm, jp, tm


def extras_for(cfg, seed=7):
    """What decode takes beside the tokens: random media for the vlm, a
    random encoder output for whisper."""
    if cfg.family == "vlm":
        return {"media": randn(seed, B, cfg.cross_attn.n_media_tokens,
                               cfg.d_model)}
    if cfg.family == "audio":
        return {"enc_out": randn(seed, B, cfg.encdec.enc_len, cfg.d_model)}
    return {}


def assert_caches_within_one_step(got, want):
    """Every leaf of the port's cache tree against the JAX tree: int8
    values at most one step apart, scales one bfloat16 step, the rest to
    1e-4."""
    got_np, want_np = caches_to_numpy(got), numpy_tree(want)
    flat_g = jax.tree_util.tree_flatten_with_path(got_np)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want_np)[0])
    assert {p for p, _ in flat_g} == set(flat_w)
    for path, g in flat_g:
        w = flat_w[path]
        name = path[-1].key
        if name in ("k", "v") and w.dtype == np.int8:
            assert g.dtype == np.int8, path
            assert int(np.abs(g.astype(np.int32) - w.astype(np.int32))
                       .max()) <= 1, path
        elif name.endswith("_scale"):
            np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=0,
                                       rtol=SCALE_RTOL, err_msg=str(path))
        else:
            np.testing.assert_allclose(as_f32(torch.from_numpy(g)),
                                       np.asarray(w, np.float32), atol=1e-4,
                                       rtol=1e-4, err_msg=str(path))


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_equal_to_jax(dtype):
    x = 3.0 * randn(0, 3, 17, 4, 16)
    x[0, 0, 0] = 0.0                      # an all-zero row: the 1e-8 floor
    x[1, 2, 3, :4] = [0.5, -0.5, 1.5, -2.5]   # halves: round to even
    jq, js = JA.quantize_kv(jnp.asarray(x).astype(getattr(jnp, dtype)))
    tq, ts = TA.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == (3, 17, 4, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))


@pytest.mark.parametrize("S_, block", [(37, 4096), (37, 16), (64, 16),
                                       (50, 64)])
def test_decode_attention_q8_matches_jax(S_, block):
    """Ragged kv_len (one row past S: the zero padding of the last block
    counts there), S not a multiple of the block, and a block below S."""
    H, K, D = 8, 2, 16
    q = randn(1, B, 1, H, D)
    kq, ks = JA.quantize_kv(jnp.asarray(randn(2, B, S_, K, D)))
    vq, vs = JA.quantize_kv(jnp.asarray(randn(3, B, S_, K, D)))
    for kv_len in (np.array([5, S_], np.int32), np.array([S_ + 3, 1],
                                                         np.int32), 7):
        want = JA.decode_attention_q8(jnp.asarray(q), kq, ks, vq, vs,
                                      jnp.asarray(kv_len), block=block)
        t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                       if a.dtype == jnp.bfloat16
                                       else np.array(a))
        got = TA.decode_attention_q8(
            torch.from_numpy(q), t(kq), t(ks).bfloat16(), t(vq),
            t(vs).bfloat16(), torch.as_tensor(kv_len), block=block)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gqa_decode_int8_drops_the_write_past_the_end():
    """A row whose pos is at the cache's end writes neither values nor
    scales (the reference's out-of-range scatter drops it); the other row
    writes both, and the output matches the reference's."""
    cfg = get_arch("deepseek-7b").reduced()
    jcfg = jax_get_arch("deepseek-7b").reduced()
    p = TA.init_gqa(torch.Generator().manual_seed(0), cfg)
    jpar = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    smax = 8
    cache = TA.init_gqa_cache(cfg, B, smax, torch.float32, quant=True)
    # history from the reference's own writes
    jcache = JA.init_gqa_cache(jcfg, B, smax, jnp.float32, quant=True)
    for t in range(3):
        x = randn(10 + t, B, 1, cfg.d_model)
        _, jcache = JA.gqa_decode(jpar, jnp.asarray(x), jcache, jcfg,
                                  jax_run())
    jcache["pos"] = jnp.asarray([smax, 3], jnp.int32)
    for name in ("k", "v", "k_scale", "v_scale"):
        a = np.array(jcache[name].astype(jnp.float32)
                       if jcache[name].dtype == jnp.bfloat16 else jcache[name])
        cache[name].copy_(torch.from_numpy(a).to(cache[name].dtype))
    cache["pos"].copy_(torch.tensor([smax, 3], dtype=torch.int32))
    before = {n: t.clone() for n, t in cache.items()}
    x = randn(20, B, 1, cfg.d_model)
    want, jnew = JA.gqa_decode(jpar, jnp.asarray(x), jcache, jcfg, jax_run())
    got, new = TA.gqa_decode(p, torch.from_numpy(x), cache, cfg,
                             RunConfig(compute_dtype="float32"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert new["pos"].tolist() == [smax + 1, 4]
    for name in ("k", "v", "k_scale", "v_scale"):
        assert new[name] is cache[name]               # in place
        assert torch.equal(cache[name][0], before[name][0]), name
        assert not torch.equal(cache[name][1, 3], before[name][1, 3]), name
        w = np.asarray(jnew[name].astype(jnp.float32))
        g = cache[name].float().numpy()
        if name in ("k", "v"):
            assert np.abs(g - w).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, atol=0, rtol=SCALE_RTOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


def test_dense_int8_decode_matches_jax_logits_and_caches():
    """Reduced deepseek-7b, six steps from empty int8 caches: logits to
    1e-3 at every step, caches within one step at the end."""
    jm, jp, tm = int8_pair("deepseek-7b")
    toks = tokens_for(tm.cfg, seed=3, seq=6)
    caches, jcaches = tm.init_caches(B, S), jm.init_caches(B, S)
    assert caches["k"].dtype == torch.int8
    assert caches["k_scale"].dtype == torch.bfloat16
    for t in range(toks.shape[1]):
        lg, caches = tm.decode_step({"tokens": toks[:, t:t + 1]}, caches)
        jlg, jcaches = jm.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcaches)
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **LOGITS)
    assert_caches_within_one_step(caches, jcaches)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b",
                                  "llama-3.2-vision-90b", "whisper-small"])
def test_int8_decode_of_each_gqa_family_matches_jax(arch):
    """One decode step from empty int8 caches: olmoe's GQA layers, the
    hybrid's shared attention, the vlm's self blocks, whisper's decoder.
    Every GQA cache of the family holds int8 values and their scales."""
    jm, jp, tm = int8_pair(arch)
    extra = extras_for(tm.cfg)
    toks = tokens_for(tm.cfg, seed=5, seq=1)
    caches, jcaches = tm.init_caches(B, S), jm.init_caches(B, S)
    leaves = {".".join(str(getattr(k, "key", k)) for k in path): a
              for path, a in jax.tree_util.tree_flatten_with_path(
                  numpy_tree(jcaches))[0]}
    ks = [n for n in leaves if n.rsplit(".", 1)[-1] == "k"]
    assert ks and all(leaves[n].dtype == np.int8 for n in ks)
    lg, caches = tm.decode_step({"tokens": toks, **extra}, caches)
    jlg, jcaches = jm.decode_step(
        jp, {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}}, jcaches)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **LOGITS)
    assert_caches_within_one_step(caches, jcaches)


def test_int8_decode_tracks_forward_within_5_percent():
    """The port's analogue of the reference's
    test_int8_kv_cache_decode_accuracy: reduced deepseek-7b, float32, its
    own weights; the int8 decode's logits within 5 % (relative to the
    largest) of the float32 forward's."""
    cfg = get_arch("deepseek-7b").reduced()
    f32 = RunConfig(attn_impl="full", remat="nothing", compute_dtype="float32")
    mf = Model(cfg, f32, device="cpu").init(seed=0)
    mq = Model(cfg, f32.with_(kv_cache_dtype="int8"), device="cpu")
    mq.load_state_dict(mf.state_dict())
    toks = tokens_for(cfg, seed=2)
    full = mf.forward({"tokens": toks})
    cq = mq.init_caches(B, S)
    assert cq["k"].dtype == torch.int8
    steps = []
    for t in range(S):
        lg, cq = mq.decode_step({"tokens": toks[:, t:t + 1]}, cq)
        steps.append(lg[:, 0])
    err = float((full - torch.stack(steps, 1)).abs().max())
    rel = err / float(full.abs().max())
    assert rel < 0.05, rel


def test_prefill_hands_back_unquantized_caches_as_the_reference_does():
    """Under kv_cache_dtype="int8" the dense prefill packs the prompt's k
    and v in the compute dtype, without scales (the reference's
    kv_to_cache); the decode after it takes the compute-dtype branch and
    matches the reference's."""
    jm, jp, tm = int8_pair("deepseek-7b")
    toks = tokens_for(tm.cfg, seed=4)
    max_len = 16
    want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, max_len)
    got, tc = tm.prefill({"tokens": toks[:, :8]}, max_len)
    assert sorted(jc) == sorted(tc) == ["k", "pos", "v"]
    assert tc["k"].dtype == torch.float32 and jc["k"].dtype == jnp.float32
    np.testing.assert_allclose(as_f32(got), as_f32(want), atol=1e-4,
                               rtol=1e-4)
    # the JAX caches carried across load in the compute dtype too
    tc2 = caches_from_numpy(numpy_tree(jc), tm)
    assert tc2["k"].dtype == torch.float32
    lg, tc = tm.decode_step({"tokens": toks[:, 8:9]}, tc)
    jlg, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, 8:9])}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), atol=1e-4, rtol=1e-4)
    assert "k_scale" not in tc


def test_int8_caches_round_trip_both_ways():
    """The reference's int8 caches after three decode steps load as the
    port's: int8 k and v stay int8 and bit-equal (never through float32),
    the bfloat16 scales keep their names and bits; back again they equal
    the reference's arrays, and a decode step from them matches."""
    jm, jp, tm = int8_pair("deepseek-7b")
    toks = tokens_for(tm.cfg, seed=6)
    jc = jm.init_caches(B, S)
    for t in range(3):
        _, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                               jc)
    tc = caches_from_numpy(numpy_tree(jc), tm)
    assert sorted(tc) == ["k", "k_scale", "pos", "v", "v_scale"]
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    back = caches_to_numpy(tc)
    for name, leaf in jc.items():
        w = np.asarray(leaf.astype(jnp.float32)) if leaf.dtype == jnp.bfloat16 \
            else np.asarray(leaf)
        assert back[name].dtype == w.dtype, name
        np.testing.assert_array_equal(back[name], w, err_msg=name)
    lg, _ = tm.decode_step({"tokens": toks[:, 3:4]}, tc)
    jlg, _ = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, 3:4])}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **LOGITS)
    # a tree with scales refuses a model whose leaves it does not fit
    with pytest.raises(KeyError, match="scale"):
        caches_from_numpy({n: a for n, a in back.items() if n != "v_scale"},
                          tm)


def test_launcher_serves_with_an_int8_cache(capsys):
    done = launch_serve.main(["--arch", "deepseek-7b", "--reduced",
                              "--device", "cpu", "--dtype", "float32",
                              "--int8-kv", "--requests", "3", "--slots", "2",
                              "--max-new", "4", "--max-len", "16"])
    assert len(done) == 3 and all(len(r.out_tokens) == 4 for r in done)
    assert "kv=int8" in capsys.readouterr().out
