"""The encoder-decoder family (whisper-small) in the port against the JAX
package, float32 on the CPU, on the same numpy inputs and on weights carried
across: cross-attention, the sinusoid, the encoder, one decoder layer, and
the whole model reduced (2 encoder layers over 16 frames): forward, prefill,
decode fed the encoder's output, caches, conversion, parameter counts, the
engine and the command line. Frames are drawn from a seed: constant frames
make every key of the cross-attention equal. Tolerances are the existing
model tests' (logits 1e-4, decode against forward 5e-4)."""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import analytic_param_count as jax_param_count
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs import get_arch
from repro_torch.convert import (caches_from_numpy, caches_to_numpy,
                                 params_to_numpy)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, analytic_param_count
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_parity import (as_f32, layer_of, model_pair, numpy_tree,
                               torch_run)

ARCH = "whisper-small"
B, S, MAX_LEN = 2, 10, 16
MODEL = dict(atol=1e-4, rtol=1e-4)


def randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def tokens_for(cfg, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(batch, seq))


def frames_for(cfg, seed=7, batch=B):
    return randn(seed, batch, cfg.encdec.enc_len, cfg.d_model)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model) of reduced whisper-small, the
    kernel switch on in both packages."""
    return model_pair(jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced())


def jax_encode(jm, jp, frames):
    """The reference's encoder half of encdec_apply, as tests/test_models.py
    writes it out."""
    cfg, run = jm.cfg, jm.run
    enc = frames + JT._sinusoid(frames.shape[1], cfg.d_model, frames.dtype)
    enc, _ = JT.stack(jp["layers"]["enc"], enc, cfg, run, kind="dense",
                      positions=jnp.arange(frames.shape[1]), causal=False)
    return JL.rms_norm(enc, jp["layers"]["enc_ln"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# modules, on weights carried across
# ---------------------------------------------------------------------------


def test_config_is_the_references():
    assert asdict(get_arch(ARCH)) == asdict(jax_get_arch(ARCH))
    cfg = get_arch(ARCH)
    assert (cfg.rope_kind, cfg.mlp_kind, cfg.d_head) == ("none", "gelu", 64)
    assert Model(cfg, device="meta").padded_vocab == 51968


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoid(dtype):
    want = JT._sinusoid(1500, 768, jnp.dtype(dtype))
    got = TT._sinusoid(1500, 768, getattr(torch, dtype), "cpu")
    assert tuple(got.shape) == (1, 1500, 768)
    np.testing.assert_allclose(as_f32(got), as_f32(want),
                               atol=2e-4 if dtype == "float32" else 1e-2,
                               rtol=0)


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("gated", [True, False])
def test_cross_attn_kv_and_cross_attn(pair, gated, rows):
    """The decoder's cross-attention (whisper's is ungated; the gate, set
    here, is a leaf it carries and does not use), a sequence and a decode
    step's one query row."""
    jm, jp, tm = pair
    jl, tl = layer_of(jp["layers"]["dec"]["cross"], 1)
    jl["gate"], tl["gate"] = np.float32(0.3), torch.tensor(0.3)
    enc = frames_for(tm.cfg)
    jkv = JA.cross_attn_kv(jl, jnp.asarray(enc))
    tkv = TA.cross_attn_kv(tl, torch.from_numpy(enc))
    for got, want in zip(tkv, jkv):
        np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    x = randn(11, B, rows, tm.cfg.d_model)
    want = JA.cross_attn(jl, jnp.asarray(x), jkv, jm.run, gated=gated)
    got = TA.cross_attn(tl, torch.from_numpy(x), tkv, tm.run, gated=gated)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)


def test_encoder(pair):
    jm, jp, tm = pair
    frames = frames_for(tm.cfg)
    want = jax_encode(jm, jp, jnp.asarray(frames))
    got = TT.encdec_encode(tm.params["layers"], torch.from_numpy(frames),
                           tm.cfg, tm.run)
    assert tuple(got.shape) == (B, tm.cfg.encdec.enc_len, tm.cfg.d_model)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)


def test_decoder_block(pair):
    jm, jp, tm = pair
    jl, tl = layer_of(jp["layers"]["dec"], 1)
    enc, x = frames_for(tm.cfg, seed=12), randn(13, B, 6, tm.cfg.d_model)
    pos = np.arange(6)
    want = JT._dec_block(jl, jnp.asarray(x), jnp.asarray(enc), jm.cfg,
                         jm.run, jnp.asarray(pos))
    got = TT._dec_block(tl, torch.from_numpy(x), torch.from_numpy(enc),
                        tm.cfg, tm.run, torch.from_numpy(pos))
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_matches_jax_with_the_kernel_switch_on(pair):
    jm, jp, tm = pair
    assert jm.run.attn_impl == "pallas" and tm.run.attn_impl == "kernel"
    toks, frames = tokens_for(tm.cfg), frames_for(tm.cfg)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                              "frames": jnp.asarray(frames)})
    got = tm.forward({"tokens": toks, "frames": frames})
    assert tuple(got.shape) == (B, S, tm.padded_vocab)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    full = Model(tm.cfg, torch_run("full"), device="cpu")
    full.load_state_dict(tm.state_dict())
    np.testing.assert_allclose(
        as_f32(full.forward({"tokens": toks, "frames": frames})),
        as_f32(got), **MODEL)


def test_prefill_returns_last_logits_and_zeroed_caches(pair):
    """As the reference: encdec_apply, the last position's logits, and
    freshly zeroed decoder caches."""
    jm, jp, tm = pair
    toks, frames = tokens_for(tm.cfg, seed=2), frames_for(tm.cfg, seed=3)
    want, wc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                               "frames": jnp.asarray(frames)}, MAX_LEN)
    got, gc = tm.prefill({"tokens": toks, "frames": frames}, MAX_LEN)
    assert tuple(got.shape) == (B, 1, tm.padded_vocab)
    assert got.untyped_storage().nbytes() == B * tm.padded_vocab * 4
    np.testing.assert_allclose(as_f32(got), as_f32(want), **MODEL)
    assert sorted(gc) == sorted(wc) == ["k", "pos", "v"]
    for name, leaf in wc.items():
        assert tuple(gc[name].shape) == tuple(leaf.shape)
        assert float(gc[name].abs().max()) == 0.0
    assert tuple(gc["k"].shape) == (tm.cfg.n_layers, B, MAX_LEN,
                                    tm.cfg.n_kv_heads, tm.cfg.d_head)


def test_init_caches_are_the_references_tree(pair):
    jm, _, tm = pair
    want, got = jm.init_caches(3, 12), tm.init_caches(3, 12)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape)
        assert float(got[name].abs().max()) == 0.0
    assert got["pos"].dtype == torch.int32 and got["k"].dtype == torch.float32


def test_decode_fed_the_encoders_output_matches_forward_and_jax(pair):
    """Decode takes enc_out, the encoder's output over the frames that
    forward takes."""
    jm, jp, tm = pair
    n = 6
    toks, frames = tokens_for(tm.cfg, seed=3, seq=n), frames_for(tm.cfg)
    full = tm.forward({"tokens": toks, "frames": frames})
    enc_out = TT.encdec_encode(tm.params["layers"], torch.from_numpy(frames),
                               tm.cfg, tm.run)
    jenc = jax_encode(jm, jp, jnp.asarray(frames))
    caches, jcaches = tm.init_caches(B, n), jm.init_caches(B, n)
    steps = []
    for t in range(n):
        lg, caches = tm.decode_step({"tokens": toks[:, t:t + 1],
                                     "enc_out": enc_out}, caches)
        jlg, jcaches = jm.decode_step(
            jp, {"tokens": jnp.asarray(toks[:, t:t + 1]), "enc_out": jenc},
            jcaches)
        steps.append(lg[:, 0])
        np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    err = float((full - torch.stack(steps, 1)).abs().max())
    assert err < 5e-4, f"decode mismatch {err}"
    for name, leaf in caches.items():
        np.testing.assert_allclose(as_f32(leaf), as_f32(jcaches[name]),
                                   **MODEL)


def test_params_and_caches_round_trip(pair):
    jm, jp, tm = pair
    back = params_to_numpy(tm)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(tm.state_dict())
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert sorted(back["layers"]) == ["dec", "enc", "enc_ln"]
    assert back["layers"]["dec"]["ln_cross"].shape == (tm.cfg.n_layers,
                                                       tm.cfg.d_model)
    assert back["layers"]["dec"]["cross"]["gate"].shape == (tm.cfg.n_layers,)
    toks = tokens_for(tm.cfg, seed=6)
    jenc = jax_encode(jm, jp, jnp.asarray(frames_for(tm.cfg)))
    jc = jm.init_caches(B, MAX_LEN)
    for t in range(2):
        _, jc = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                    "enc_out": jenc}, jc)
    tc = caches_from_numpy(numpy_tree(jc), tm)
    lg, tc = tm.decode_step({"tokens": toks[:, 2:3],
                             "enc_out": np.array(jenc)}, tc)
    jlg, jc2 = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, 2:3]),
                                   "enc_out": jenc}, jc)
    np.testing.assert_allclose(as_f32(lg), as_f32(jlg), **MODEL)
    out = caches_to_numpy(tc)
    for name, leaf in out.items():
        np.testing.assert_allclose(leaf, np.asarray(jc2[name]), **MODEL)
    with pytest.raises(ValueError, match="pos"):
        caches_from_numpy({**out, "pos": out["pos"][:1]}, tm)


def test_param_count_equals_jax_and_init():
    for jcfg, cfg in ((jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()),
                      (jax_get_arch(ARCH), get_arch(ARCH))):
        assert analytic_param_count(cfg) == jax_param_count(jcfg)
    cfg = get_arch(ARCH).reduced()
    model = Model(cfg, device="cpu").init(seed=0)
    assert analytic_param_count(cfg) == sum(
        p.numel() for p in model.tree.parameters())
    # untied: embed and head are two (51968, 768) leaves
    assert get_arch(ARCH).param_count() == 278_051_340


# ---------------------------------------------------------------------------
# the engine and the command line
# ---------------------------------------------------------------------------


def test_same_greedy_tokens_as_the_jax_engine():
    """Both engines feed their all-zero enc_out: the reference's in
    float32, the port's in the compute dtype, which the model takes without
    a copy."""
    jm, jp, tm = model_pair(jax_get_arch(ARCH).reduced(),
                            get_arch(ARCH).reduced(), jax_attn="full")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tm.cfg.vocab_size, size=n).tolist()
               for n in (3, 5, 2)]
    jeng = JServeEngine(jm, jp, slots=2, max_len=32)
    teng = ServeEngine(tm, slots=2, max_len=32)
    assert sorted(teng._extras) == ["enc_out"]
    assert teng._extras["enc_out"].shape == (2, 16, tm.cfg.d_model)
    assert tm._extra(teng._extras, "enc_out") is teng._extras["enc_out"]
    for rid, prompt in enumerate(prompts):
        jeng.submit(JRequest(rid, prompt=list(prompt), max_new_tokens=5))
        teng.submit(Request(rid, prompt=list(prompt), max_new_tokens=5))
    want = {r.rid: r.out_tokens for r in jeng.run()}
    got = {r.rid: r.out_tokens for r in teng.run()}
    assert got == want


def test_launcher_runs_reduced_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--dtype", "float32", "--requests", "3",
                              "--slots", "2", "--max-new", "3",
                              "--prompt-len", "4", "--max-len", "16"])
    assert len(done) == 3 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 256 for r in done for t in r.out_tokens)
    assert f"[serve] {ARCH}: 3 requests, 9 tokens" in capsys.readouterr().out
